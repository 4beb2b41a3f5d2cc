"""repro_torch: the PyTorch / CUDA port of the repro package."""


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error raised for a feature of the JAX package the port does not
    serve yet, naming its ROADMAP item."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, "
                               f"{item})")
