"""Device resolution and the paddle device API.

The port's counterpart of ``paddle_tpu.core.device``: where the JAX
package asks PJRT for its default device, every entry point here calls
:func:`resolve_device`, which picks the CUDA card unless the caller
asks for the CPU by name. It never falls back to the CPU by itself —
a run that was meant for the card and finds none fails at once.

The paddle surface (``set_device``, ``get_device``, ``device_count``,
``is_compiled_with_cuda`` and the places) keeps one current device for
the eager core: tensors and parameters are made there. Until
``set_device`` names one it is the card, so ``paddle.to_tensor`` on a
machine without CUDA raises unless ``set_device("cpu")`` came first.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "Place", "CPUPlace", "CUDAPlace", "TPUPlace",
           "set_device", "get_device", "current_device", "device_count",
           "is_compiled_with_cuda", "is_compiled_with_tpu"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> the CPU; any CUDA device
    string -> that device. Raises ``RuntimeError`` when a CUDA device
    is wanted (explicitly or by default) and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: paddle_tpu_torch runs on the "
                "card by default — pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


class Place:
    """A device place, e.g. ``Place('gpu', 0)`` (paddle's name for a
    CUDA card is ``gpu``)."""

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = device_type
        self.device_id = device_id

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)


def CPUPlace(device_id: int = 0) -> Place:
    return Place("cpu", device_id)


def CUDAPlace(device_id: int = 0) -> Place:
    return Place("gpu", device_id)


def TPUPlace(device_id: int = 0) -> Place:
    """Accepted for the JAX package's code: the port's accelerator is
    the CUDA card, so this is ``CUDAPlace``."""
    return CUDAPlace(device_id)


def place_of(dev: torch.device) -> Place:
    if dev.type == "cpu":
        return CPUPlace()
    return CUDAPlace(dev.index or 0)


_current: Optional[torch.device] = None


def _parse(device) -> torch.device:
    if isinstance(device, Place):
        return resolve_device(device.torch_device())
    if isinstance(device, torch.device):
        return resolve_device(device)
    kind, _, idx = str(device).partition(":")
    if kind in ("gpu", "cuda", "tpu"):
        return resolve_device(f"cuda:{idx}" if idx else "cuda")
    if kind == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unsupported device {device!r} (gpu, gpu:N or cpu)")


def set_device(device) -> Place:
    """``set_device('gpu')`` / ``'gpu:1'`` / ``'cpu'`` (``'cuda'`` and
    ``'tpu'`` name the card too). Returns the place."""
    global _current
    _current = _parse(device)
    return place_of(_current)


def current_device() -> torch.device:
    """The eager core's device: the one ``set_device`` named, else the
    card (raises without CUDA)."""
    global _current
    if _current is None:
        _current = resolve_device(None)
    return _current


def get_device() -> str:
    dev = current_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


def device_count(device_type: Optional[str] = None) -> int:
    if device_type == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_tpu() -> bool:
    return False
