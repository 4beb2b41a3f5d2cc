"""Table-3-style downstream fine-tune on the PyTorch port: classification
head on a DR-RL LM, comparing full-rank vs DR-RL vs Performer (and the
other methods of Table 3) on the synthetic sentiment task.

    PYTHONPATH=src python examples/finetune_classification_torch.py               # on the GPU
    PYTHONPATH=src python examples/finetune_classification_torch.py --device cpu

The accuracies go to ``benchmarks/artifacts/torch_table3.json``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.torch_table3_downstream import run  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(ft_steps=40, quick=True, device=args.device)


if __name__ == "__main__":
    main()
