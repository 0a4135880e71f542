"""Optimizers of the port (Adam and AdamW so far)."""
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401
