"""Whole-step training entry of the port (``TrainStep`` so far)."""
from .api import TrainStep  # noqa: F401
