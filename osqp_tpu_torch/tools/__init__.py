"""Measurement tools for the port's kernels; they need an NVIDIA GPU."""
