"""Measurement tools for the port's kernels; they need an NVIDIA GPU."""


def require(cond, what):
    """Raise ``AssertionError(what)`` unless ``cond``: a check of a tool,
    example or smoke phase, kept under ``python -O`` too."""
    if not cond:
        raise AssertionError(what)
