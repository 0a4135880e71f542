"""General helpers: the deprecation decorator, the installation check,
the version gate and ``try_import``.

The port of ``paddle_tpu/utils/helpers.py``: ``deprecated``,
``require_version`` and ``try_import`` as there; ``run_check`` runs
its matmul and gradient on the card.
"""
from __future__ import annotations

import functools
import warnings
from types import ModuleType
from typing import Callable, Optional

__all__ = ["deprecated", "run_check", "require_version", "try_import"]


def deprecated(update_to: str = "", since: str = "", reason: str = "",
               level: int = 0) -> Callable:
    """Mark an API deprecated (ref: utils/deprecated.py): appends a
    deprecation notice to the docstring and warns on call. level 0 =
    note only, 1 = also warn at call time, 2 = raise (API removed)."""

    def decorator(fn):
        note = "\n\n.. warning:: Deprecated"
        if since:
            note += f" since {since}"
        note += "."
        if update_to:
            note += f" Use :ref:`{update_to}` instead."
        if reason:
            note += f" Reason: {reason}"
        fn.__doc__ = (fn.__doc__ or "") + note

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if level == 2:
                raise RuntimeError(
                    f"API {fn.__name__} has been deprecated"
                    + (f"; use {update_to} instead" if update_to else ""))
            if level >= 1:
                warnings.warn(
                    f"API {fn.__name__} is deprecated"
                    + (f" since {since}" if since else "")
                    + (f"; use {update_to} instead" if update_to else ""),
                    DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return wrapper

    return decorator


def run_check(device=None) -> None:
    """Check the installation: one small matmul and its gradient on the
    card (``device="cpu"`` runs them on the CPU when asked), checked
    against the closed form, then the verdict with the device's name.
    Without a card and without ``device="cpu"`` it raises."""
    import torch

    dev = torch.device(device) if device is not None else \
        torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else None
    if dev is None:
        raise RuntimeError("run_check: torch sees no CUDA device (pass "
                           "device='cpu' to check on the CPU)")
    x = torch.ones(4, 4, device=dev, requires_grad=True)
    (x @ x).sum().backward()
    # d/dx sum(x @ x) = 1 xᵀ + xᵀ 1 = 8 everywhere for ones
    if x.grad.shape != (4, 4) or not bool((x.grad == 8.0).all()):
        raise RuntimeError(f"run_check: the gradient on {dev} is wrong")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "CPU"
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"paddle_tpu_torch is installed successfully! device={dev} "
          f"({name}), {n} device(s) visible.")


def require_version(min_version: str,
                    max_version: Optional[str] = None) -> None:
    """Raise unless the installed version is within [min, max]
    (ref: utils/__init__ require_version)."""
    from .. import __version__

    def key(v: str):
        parts = []
        for p in str(v).split("."):
            digits = "".join(ch for ch in p if ch.isdigit())
            parts.append(int(digits) if digits else 0)
        return tuple(parts + [0] * (4 - len(parts)))

    if not isinstance(min_version, str) or (
            max_version is not None and not isinstance(max_version, str)):
        raise TypeError("version arguments must be strings")
    cur = key(__version__)
    if cur < key(min_version):
        raise Exception(
            f"installed version {__version__} < required minimum "
            f"{min_version}")
    if max_version is not None and cur > key(max_version):
        raise Exception(
            f"installed version {__version__} > required maximum "
            f"{max_version}")


def try_import(module_name: str,
               err_msg: Optional[str] = None) -> ModuleType:
    """Import a module, raising a friendlier install hint on failure
    (ref: utils/lazy_import.py)."""
    import importlib
    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(
            err_msg or f"module {module_name!r} is required but not "
            f"installed; pip install {module_name.split('.')[0]}") from e
