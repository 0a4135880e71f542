"""Dtypes of the port.

The counterpart of ``paddle_tpu.core.dtype``: the paddle dtype names
map to ``torch.dtype`` objects (``paddle_tpu_torch.float32`` is
``torch.float32``), and :func:`convert_dtype` takes a name, a torch
dtype or a numpy dtype. Unlike the JAX package, which runs with x64
off (its ``int64`` arrays are int32 on the device), the port keeps real
64-bit integers and floats.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "dtype_name", "is_floating_point", "is_integer",
           "set_default_dtype", "get_default_dtype"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
}
_DTYPE_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()}

_FLOATING = {float16, bfloat16, float32, float64}
_INTEGRAL = {uint8, int8, int16, int32, int64}

_default_dtype = float32


def convert_dtype(dtype):
    """A dtype name, ``torch.dtype``, numpy dtype or numpy scalar type
    -> ``torch.dtype`` (``None`` stays ``None``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _NAME_TO_DTYPE[dtype]
        except KeyError:
            raise TypeError(f"Unsupported dtype name: {dtype!r}") from None
    name = np.dtype(dtype).name
    if name not in _NAME_TO_DTYPE:
        raise TypeError(f"Unsupported dtype: {dtype!r}")
    return _NAME_TO_DTYPE[name]


def dtype_name(dtype) -> str:
    d = convert_dtype(dtype)
    return _DTYPE_TO_NAME.get(d, str(d))


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in _FLOATING


def is_integer(dtype) -> bool:
    return convert_dtype(dtype) in _INTEGRAL


def set_default_dtype(d):
    """The dtype of float tensors made from Python floats and of new
    parameters; floating dtypes only."""
    global _default_dtype
    d = convert_dtype(d)
    if d not in _FLOATING:
        raise TypeError(
            f"set_default_dtype only supports floating dtypes, got {d}")
    _default_dtype = d


def get_default_dtype():
    return _default_dtype
