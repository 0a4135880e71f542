"""Incubating modules of the port: the MoE layer and its dispatch, and
``incubate.nn`` (the fused functionals)."""
from . import nn  # noqa: F401
