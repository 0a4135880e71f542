"""The port's high-level API: ``Model``, ``summary``, ``flops`` and the
callbacks."""
from .model import Model, summary, flops  # noqa: F401
from . import callbacks  # noqa: F401
