"""The port's random state.

The counterpart of ``paddle_tpu.core.random``: where the JAX package
keeps a root PRNG key and folds a counter into it for every draw, the
port keeps one explicit ``torch.Generator`` on the CPU, seeded 0 at
import like the JAX default generator. Random ops on the card take
their seeds from it, drawn on the host, so a draw never waits for the
device:

- :func:`kernel_seed` — a 64-bit seed for the flash-attention kernels'
  Philox keep mask (``ops.kernels.flash_attention``);
- :func:`hash_seed` — a uint32 seed for the hash dropout of
  ``nn.functional.dropout`` (the JAX package's ``derive_seed`` of a
  fresh key, as ``jnp.uint32``);
- :func:`device_generator` — a generator on a device, seeded from this
  one, for Bernoulli draws made there;
- :func:`generator_for` — the generator the eager core's random ops and
  the initializers draw from: this one on the CPU, a fresh device
  generator seeded from it on the card (so ``seed`` makes both
  deterministic).

:func:`draws` counts the draws made from this generator (seeds and
device generators alike): the whole-step capture (``jit/sot.py``)
keeps a step that drew one out of a CUDA graph, which would freeze the
Python int it drew.

The JAX and the port's streams differ (a JAX key is not a torch
generator state); tests that need the same random numbers on both
sides pass them explicitly.
"""
from __future__ import annotations

import torch

__all__ = ["seed", "get_rng_state", "set_rng_state", "default_generator",
           "kernel_seed", "hash_seed", "device_generator", "generator_for",
           "draws"]

_generator = torch.Generator(device="cpu")
_generator.manual_seed(0)


def seed(value: int) -> torch.Generator:
    """Reseed the port's generator (paddle's ``paddle.seed``)."""
    return _generator.manual_seed(int(value))


def default_generator() -> torch.Generator:
    return _generator


def get_rng_state() -> torch.Tensor:
    return _generator.get_state()


def set_rng_state(state: torch.Tensor) -> None:
    _generator.set_state(state)


_draws = 0


def draws() -> int:
    """How many draws (seeds, device generators, CPU draws through
    :func:`generator_for`) the port's generator has served."""
    return _draws


def _words(n: int):
    global _draws
    _draws += 1
    return torch.randint(0, 2 ** 32, (n,), dtype=torch.int64,
                         generator=_generator).tolist()


def kernel_seed() -> int:
    """A fresh 64-bit seed (Python int) for the flash kernels' Philox."""
    lo, hi = _words(2)
    return lo | hi << 32


def hash_seed() -> int:
    """A fresh uint32 seed (Python int) for the hash dropout."""
    return _words(1)[0]


def device_generator(device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the port's
    generator: Bernoulli masks are drawn where they are used."""
    return torch.Generator(device=device).manual_seed(hash_seed())


def generator_for(device) -> torch.Generator:
    """The port's generator for CPU draws, a device generator seeded
    from it for draws on the card."""
    if torch.device(device).type == "cpu":
        global _draws
        _draws += 1
        return _generator
    return device_generator(device)
