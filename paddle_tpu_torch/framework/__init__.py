"""Checkpointing of the port: ``save`` / ``load`` and the crash-safe
persistence under them, in the JAX package's file format."""
from .io import save, load  # noqa: F401
from .checkpoint import (  # noqa: F401
    CheckpointCorruptError, CheckpointManager, atomic_save,
    extract_state_dict, load_checkpoint, verify_checkpoint)
