"""``incubate.nn`` of the port: its fused functionals
(``incubate.nn.functional``). The fused layers of the JAX package
(``FusedLinear``, ``FusedDropoutAdd``, ``FusedMultiHeadAttention``,
``FusedFeedForward``, ``FusedTransformerEncoderLayer``) are not ported
yet."""
from . import functional  # noqa: F401
from .functional import fused_dropout_add  # noqa: F401

__all__ = ["functional"]
