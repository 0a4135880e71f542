"""Device resolution.

The port's counterpart of ``paddle_tpu.core.device``: where the JAX
package asks PJRT for its default device, every entry point here calls
:func:`resolve_device`, which picks the CUDA card unless the caller
asks for the CPU by name. It never falls back to the CPU by itself —
a run that was meant for the card and finds none fails at once.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


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
