"""repro_torch: the PyTorch / CUDA port of the repro package (serving slice)."""
