"""Automatic mixed precision of the port (``paddle.amp``): ``auto_cast``
/ ``decorate`` (``amp/auto_cast.py``, the op-name cast hook of
``core.autograd.apply_op``) and ``GradScaler``."""
from .auto_cast import (  # noqa: F401
    amp_guard, amp_signature, amp_state, auto_cast, autocast, black_list,
    decorate, white_list,
)
from .grad_scaler import GradScaler  # noqa: F401


def is_float16_supported(device=None) -> bool:
    """The card computes f16 (and the CPU runs it, slowly)."""
    return True


def is_bfloat16_supported(device=None) -> bool:
    return True
