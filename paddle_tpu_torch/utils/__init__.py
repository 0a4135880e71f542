"""Utilities of the port (gradient clipping so far)."""
from . import clip_grad  # noqa: F401
