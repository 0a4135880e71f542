"""The port's random state: key streams whose state lives on the device.

The counterpart of ``paddle_tpu.core.random`` (``Generator``,
``TracedKeyStream``, ``key_stream``, ``next_key``, ``seed_epoch``,
``derive_seed``, ``get_rng_state`` / ``set_rng_state`` and
``RNGStatesTracker``, with their names and meanings). Where the JAX
package keeps a root PRNG key and folds a counter into it for every
draw, a port :class:`Generator` keeps ``(seed, counter)``: on every
device it draws on, one int64 tensor ``[seed_lo, seed_hi, counter]``
allocated once, outside any CUDA graph's pool, and on the host a mirror
of the counter. A draw on the device advances that tensor in place
(``add_``) and derives the key from it with device ops: it never reads
the host, so a CUDA graph that holds the draw replays a fresh key every
time (``jit/sot.py`` advances the mirror by the draws it captured).

**A key** is an int64 tensor ``[2]`` on the device it was drawn for,
two unsigned 32-bit words. The flash kernels read it from device memory
as their Philox key (``ops.kernels.flash_attention``);
:func:`derive_seed` folds it to the one 32-bit seed of the hash dropout
(``nn.functional.dropout``), as the JAX function folds a JAX key.

**The mixing** (the port's own: torch cannot reproduce threefry). With
``fmix32`` the murmur3 finalizer (``h ^= h >> 16; h *= 0x85EBCA6B;
h ^= h >> 13; h *= 0xC2B2AE35; h ^= h >> 16``, mod 2³²), folding the
integer ``n`` into the key ``(w0, w1)`` gives::

    h0 = fmix32(w0 + n * 0x9E3779B1)       h1 = fmix32(w1 + n * 0x85EBCA77)
    key = (fmix32(h0 ^ h1 * 0x27D4EB2F),   fmix32(h1 ^ h0 * 0x27D4EB2F))

(sums and products mod 2³², ``n`` mod 2⁶⁴). Draw ``n`` (1, 2, ...) of a
generator seeded ``s`` is the fold of ``n`` into ``(s mod 2³²,
s >> 32 mod 2³²)``, the JAX generator's ``fold_in(key(seed), counter)``;
a :class:`TracedKeyStream` folds its own counter into its root key. The
same ``(seed, counter)`` gives the same key on any device and on the
host, so a step captured in a graph and the same step run eager from
the same ``paddle.seed`` draw the same masks.

**Device draws.** The random ops draw from a key like the dropouts:
:func:`bits` hashes each element's row-major index ``i`` under the two
words ``(w0, w1)`` of one key (two keyed rounds of ``fmix32``, each a
bijection of ``i`` for ``i < 2³²``)::

    a = fmix32(i * 0x9E3779B1 + w0)     bits = fmix32((a ^ w1) * 0x85EBCA77)

with in-place int32 device ops (products wrap mod 2³²), in chunks of
2²⁴ elements. :func:`uniform`,
:func:`normal` (Box–Muller over the indices ``[0, n)`` and ``[n, 2n)``),
:func:`bernoulli` / :func:`keep_mask`, :func:`randint`,
:func:`permutation` (an argsort of the distinct bits, as
``jax.random.permutation`` sorts random keys), :func:`multinomial`,
:func:`exponential` and :func:`gumbel` build on it. Each call takes one
key (``next_key(device)``, or the ``key=`` it is given), so a value is
a function of the ``(seed, counter)`` stream alone: ``get_rng_state`` /
``set_rng_state`` replay it, the same draw on the card and on the CPU
gives the same bits, and a CUDA graph that holds the call draws afresh
on every replay.

**Host draws.** What still takes a host seed — the rejection samplers
(``standard_gamma``, ``poisson``, ``binomial``) and the ``io`` samplers
— gets a ``torch.Generator`` seeded with the next key of the default
generator, computed on the host (:func:`generator_for`,
:func:`device_generator`); draws whose values shape host-side work
(fractional pooling's windows, ``class_center_sample``'s negatives)
take that key as a CPU tensor (:func:`host_key`) into the device draws
above. :func:`draws` counts those draws only: a
graph would freeze their seed, so ``jit/sot.py`` keeps a step that made
one out of capture (``"rng"``).

The JAX and the port's streams differ (a JAX key is not a port key);
tests that need the same random numbers on both sides pass them
explicitly.
"""
from __future__ import annotations

import math
import os
import threading
import weakref
from typing import Dict, Tuple

import torch

__all__ = ["Generator", "TracedKeyStream", "key_stream", "next_key",
           "seed", "seed_epoch", "default_generator", "derive_seed",
           "get_rng_state", "set_rng_state", "RNGStatesTracker",
           "device_generator", "generator_for", "draws", "host_key", "bits",
           "uniform", "normal", "bernoulli", "keep_mask", "randint",
           "permutation", "multinomial", "exponential", "gumbel"]

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF
_FOLD = (0x9E3779B1, 0x85EBCA77)
_CROSS = 0x27D4EB2F


def _fmix32(h):
    """murmur3's finalizer on an int or an int64 tensor in [0, 2³²) (the
    int64 products wrap; their low 32 bits are exact)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _fold_words(w0: int, w1: int, n: int) -> Tuple[int, int]:
    """The mixing of the module docstring on the host."""
    n &= _M64
    h0 = _fmix32((w0 + n * _FOLD[0]) & _M32)
    h1 = _fmix32((w1 + n * _FOLD[1]) & _M32)
    return (_fmix32(h0 ^ (h1 * _CROSS) & _M32),
            _fmix32(h1 ^ (h0 * _CROSS) & _M32))


_fold_consts: Dict[torch.device, torch.Tensor] = {}


def _consts(device: torch.device) -> torch.Tensor:
    c = _fold_consts.get(device)
    if c is None:
        _no_capture(device, "its constants")
        c = torch.tensor(_FOLD, dtype=torch.int64).to(device)
        _fold_consts[device] = c
    return c


def _fold(key: torch.Tensor, n) -> torch.Tensor:
    """The mixing on the device: ``n`` an int or an int64 tensor ``[1]``
    on ``key``'s device (a generator's counter)."""
    h = _fmix32((key + n * _consts(key.device)) & _M32)
    return _fmix32(h ^ ((h.flip(0) * _CROSS) & _M32))


def _device(device) -> torch.device:
    if device is None:
        from .device import current_device
        device = current_device()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and \
        torch.cuda.is_current_stream_capturing()


def _no_capture(device: torch.device, what: str) -> None:
    if _capturing(device):
        raise RuntimeError(
            f"core.random: {what} on {device} would be written inside a "
            f"CUDA graph capture; draw once on {device} before capturing")


class Generator:
    """``(seed, counter)`` with the counter's state on each device it
    draws on (see the module docstring); thread-safe."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._states: Dict[torch.device, torch.Tensor] = {}
        # the counter each device's state holds (the host's own may be
        # ahead: host draws and draws on another device)
        self._synced: Dict[torch.device, int] = {}
        _generators.add(self)
        self.manual_seed(seed)

    def _write(self, dev: torch.device) -> None:
        """Put ``(seed, counter)`` into ``dev``'s state in place: fills,
        so no host sync and the address a graph holds stays."""
        _no_capture(dev, "a generator state write")
        st = self._states[dev]
        s = self._seed & _M64
        st[0].fill_(s & _M32)
        st[1].fill_(s >> 32)
        st[2].fill_(self._counter)
        self._synced[dev] = self._counter

    def manual_seed(self, seed: int):
        with self._lock:
            self._seed = int(seed)
            self._counter = 0
            for dev in self._states:
                self._write(dev)
        _bump_seed_epoch()
        return self

    def initial_seed(self) -> int:
        return self._seed

    def _state(self, dev: torch.device) -> torch.Tensor:
        """``dev``'s state, made and brought up to the host counter."""
        st = self._states.get(dev)
        if st is None:
            _no_capture(dev, "a new generator state")
            _consts(dev)
            st = self._states[dev] = torch.zeros(3, dtype=torch.int64,
                                                 device=dev)
            self._write(dev)
        elif self._synced[dev] != self._counter:
            self._write(dev)
        return st

    def prepare(self, device=None) -> torch.Tensor:
        """The state on ``device``, made and in step with the host: what
        a graph that draws from this generator holds (called before a
        capture and before each replay)."""
        dev = _device(device)
        with self._lock:
            return self._state(dev)

    def next_key(self, device=None) -> torch.Tensor:
        """A fresh key on ``device`` (the current device by default);
        each call advances the stream."""
        dev = _device(device)
        with self._lock:
            st = self._state(dev)
            st[2:].add_(1)
            self._counter += 1
            self._synced[dev] = self._counter
            key = _fold(st[:2], st[2:])
        if _draw_observer is not None:
            _draw_observer(self, dev)
        return key

    def _host_key(self) -> Tuple[int, int]:
        """The next key's words computed on the host (a host draw)."""
        with self._lock:
            self._counter += 1
            s = self._seed & _M64
            return _fold_words(s & _M32, s >> 32, self._counter)

    def _rewind(self, dev: torch.device, n: int) -> None:
        """A capture recorded ``n`` draws from ``dev``'s state without
        running them: the host mirror goes back to what the state
        holds."""
        with self._lock:
            self._counter -= n
            self._synced[dev] = self._counter

    def _advance(self, dev: torch.device, n: int) -> None:
        """A graph replay drew ``n`` keys from ``dev``'s state."""
        with self._lock:
            self._counter += n
            self._synced[dev] = self._counter

    def get_state(self) -> Tuple[int, int]:
        return (self._seed, self._counter)

    def set_state(self, state) -> None:
        with self._lock:
            self._seed, self._counter = int(state[0]), int(state[1])
            for dev in self._states:
                self._write(dev)
        _bump_seed_epoch()


_generators: "weakref.WeakSet[Generator]" = weakref.WeakSet()
# device tensors a forked child dropped: kept referenced, never freed
# there (the child has no CUDA context of its own)
_fork_orphans = []


def _forget_device_states() -> None:
    """In a forked child (a DataLoader worker): the parent's CUDA state
    tensors are unusable there, so every generator keeps its CPU state
    only and reseeding writes no device memory; the locks are new (one
    held by another thread at the fork would stay held)."""
    for g in list(_generators):
        g._lock = threading.Lock()
        for dev in [d for d in g._states if d.type != "cpu"]:
            _fork_orphans.append(g._states.pop(dev))
            g._synced.pop(dev, None)
    for dev in [d for d in _fold_consts if d.type != "cpu"]:
        _fork_orphans.append(_fold_consts.pop(dev))


os.register_at_fork(after_in_child=_forget_device_states)


class TracedKeyStream:
    """A key stream under a root key tensor: ``next_key`` folds its own
    counter into the root (device ops on the root's device). Installed
    by :class:`key_stream`; a graph that holds its draws replays them
    on whatever the root tensor holds."""

    def __init__(self, key: torch.Tensor):
        self._key = key
        self._counter = 0

    def next_key(self) -> torch.Tensor:
        self._counter += 1
        return _fold(self._key, self._counter)


_stream_stack = []


class key_stream:
    """Context manager installing a :class:`TracedKeyStream` as the
    source of :func:`next_key`; nested streams stack."""

    def __init__(self, key: torch.Tensor):
        self._stream = TracedKeyStream(key)

    def __enter__(self):
        _stream_stack.append(self._stream)
        return self._stream

    def __exit__(self, *exc):
        _stream_stack.pop()
        return False


# bumped on every re-seed or state restore (manual_seed / set_state /
# set_rng_state) of any generator, as in the JAX module
_seed_epoch = 0


def _bump_seed_epoch():
    global _seed_epoch
    _seed_epoch += 1


def seed_epoch() -> int:
    return _seed_epoch


_default_generator = Generator(0)


def seed(value: int) -> Generator:
    """Reseed the default generator (paddle's ``paddle.seed``)."""
    _default_generator.manual_seed(value)
    return _default_generator


def default_generator() -> Generator:
    return _default_generator


# hooks: _key_observer() is called on every next_key() and every host
# draw (the JAX module's; jit/sot.py keeps a recording that drew out of
# replay); _draw_observer(generator, device) on every device draw of a
# Generator (jit/sot.py records a capture's draws through it)
_key_observer = None
_draw_observer = None


def next_key(device=None) -> torch.Tensor:
    """A fresh key from the innermost :class:`key_stream`, else from the
    default generator on ``device`` (the current device by default)."""
    if _key_observer is not None:
        _key_observer()
    if _stream_stack:
        return _stream_stack[-1].next_key()
    return _default_generator.next_key(device)


def derive_seed(key: torch.Tensor, dtype=None) -> torch.Tensor:
    """Fold a key to one 32-bit scalar tensor on its device: its last
    word, as the JAX function folds a key. ``dtype`` None or
    ``torch.int32``: the word bitcast to int32; ``"uint32"``: the
    unsigned word, held in int64 (torch's uint32 has few ops)."""
    w = key.reshape(-1)[-1]
    if dtype is None or dtype == torch.int32:
        return (w - ((w >> 31) << 32)).to(torch.int32)
    if dtype == "uint32":
        return w.clone()
    raise TypeError(f"derive_seed: dtype {dtype} (int32 or 'uint32')")


def get_rng_state() -> Tuple[int, int]:
    return _default_generator.get_state()


def set_rng_state(state) -> None:
    _default_generator.set_state(state)


class RNGStatesTracker:
    """Named generators for parallel determinism (the JAX class: TP
    layers' 'global' and 'local' dropout streams)."""

    def __init__(self):
        self._seeds: Dict[str, Generator] = {}

    def add(self, name: str, seed: int):
        if name in self._seeds:
            raise ValueError(f"RNG state {name} already exists")
        self._seeds[name] = Generator(seed)

    def rng_state(self, name: str) -> Generator:
        if name not in self._seeds:
            raise ValueError(f"Unknown RNG state {name}")
        return self._seeds[name]

    def next_key(self, name: str, device=None) -> torch.Tensor:
        return self.rng_state(name).next_key(device)


# -- device draws -------------------------------------------------------------

_CHUNK = 1 << 24
_ROUND2 = 0x85EBCA77


def _key_for(key, device) -> torch.Tensor:
    """``key``, else a fresh key of the stream on ``device``."""
    return next_key(device) if key is None else key


def _s32(c: int) -> int:
    """A 32-bit constant as the int32 with its bits."""
    return c - (1 << 32) if c >= 1 << 31 else c


_MUL = tuple(_s32(c) for c in (_FOLD[0], 0x85EBCA6B, 0xC2B2AE35, _ROUND2))


def _fmix32_(h: torch.Tensor) -> torch.Tensor:
    """``_fmix32`` in place on int32 words (products wrap mod 2³²; a
    right shift is arithmetic, so the shifted-in bits are masked)."""
    h.bitwise_xor_((h >> 16) & 0xFFFF)
    h.mul_(_MUL[1])
    h.bitwise_xor_((h >> 13) & 0x7FFFF)
    h.mul_(_MUL[2])
    return h.bitwise_xor_((h >> 16) & 0xFFFF)


def _words(key: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """The words of the indices ``[start, start + n)`` under ``key``, as
    int32 holding the 32 bits, on ``key``'s device."""
    if start + n > 1 << 32:
        raise ValueError(f"core.random: {start + n} draws from one key "
                         f"(at most 2^32)")
    k = key - ((key >> 31) << 32)        # each word's bits, signed
    w0, w1 = k[0].to(torch.int32), k[1].to(torch.int32)

    def chunk(lo, hi):
        if start + hi <= 1 << 31:
            h = torch.arange(start + lo, start + hi, dtype=torch.int32,
                             device=key.device)
        else:
            h = torch.arange(start + lo, start + hi, dtype=torch.int64,
                             device=key.device)
            h = (h - ((h >> 31) << 32)).to(torch.int32)
        _fmix32_(h.mul_(_MUL[0]).add_(w0))
        return _fmix32_(h.bitwise_xor_(w1).mul_(_MUL[3]))
    if n <= _CHUNK:
        return chunk(0, n)
    out = torch.empty(n, dtype=torch.int32, device=key.device)
    for lo in range(0, n, _CHUNK):
        out[lo:lo + _CHUNK] = chunk(lo, min(n, lo + _CHUNK))
    return out


def _index_bits(key: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """The words of :func:`_words` as int64 in [0, 2³²)."""
    return _words(key, start, n).to(torch.int64) & _M32


def _top24(key, start, n) -> torch.Tensor:
    """The words' top 24 bits, int32 in [0, 2²⁴)."""
    return (_words(key, start, n) >> 8) & 0xFFFFFF


def _shape_of(shape) -> Tuple[int, ...]:
    if isinstance(shape, int):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def bits(shape, key=None, device=None) -> torch.Tensor:
    """Uniform 32-bit words (int64 in [0, 2³²)) of ``shape`` from one
    key (``next_key(device)`` unless ``key`` is given)."""
    shape = _shape_of(shape)
    key = _key_for(key, device)
    return _index_bits(key, 0, math.prod(shape)).view(shape)


def _unit(key, start, n, dtype, open_low=False) -> torch.Tensor:
    """``n`` uniforms in [0, 1) (in (0, 1) with ``open_low``) from the
    indices ``[start, start + n)``: 24 bits for f32 and narrower, all
    32 for f64."""
    if dtype == torch.float64:
        u = _index_bits(key, start, n).to(torch.float64)
        return (u + 0.5 if open_low else u) * 2.0 ** -32
    u = _top24(key, start, n).to(torch.float32)
    return (u + 0.5 if open_low else u) * 2.0 ** -24


def _compute_dtype(dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def uniform(shape, low=0.0, high=1.0, dtype=torch.float32, device=None,
            key=None) -> torch.Tensor:
    """Uniforms in ``[low, high)`` of ``shape`` and ``dtype``."""
    shape = _shape_of(shape)
    key = _key_for(key, device)
    u = _unit(key, 0, math.prod(shape), _compute_dtype(dtype))
    return (u * (high - low) + low).to(dtype).view(shape)


def normal(shape, mean=0.0, std=1.0, dtype=torch.float32, device=None,
           key=None) -> torch.Tensor:
    """Normals of ``shape``: Box–Muller, ``sqrt(-2 ln(1 - u1)) ·
    cos(2π u2)`` with ``u1`` from the indices ``[0, n)`` and ``u2`` from
    ``[n, 2n)``."""
    shape = _shape_of(shape)
    key = _key_for(key, device)
    n = math.prod(shape)
    cd = _compute_dtype(dtype)
    r = torch.sqrt(-2.0 * torch.log1p(-_unit(key, 0, n, cd)))
    z = r * torch.cos((2.0 * math.pi) * _unit(key, n, n, cd))
    return (z * std + mean).to(dtype).view(shape)


def keep_mask(shape, keep_prob: float, device=None,
              key=None) -> torch.Tensor:
    """A bool mask of ``shape``, each element True with probability
    ``keep_prob`` to 2⁻²⁴ (the words' top 24 bits below
    ``floor(keep_prob · 2²⁴)``: the ``uniform`` draw below
    ``keep_prob``)."""
    shape = _shape_of(shape)
    key = _key_for(key, device)
    thresh = min(int(keep_prob * 2 ** 24), 2 ** 24)
    return (_top24(key, 0, math.prod(shape)) < thresh).view(shape)


def bernoulli(p: torch.Tensor, key=None) -> torch.Tensor:
    """A bool tensor of ``p``'s shape, True with probability ``p``."""
    key = _key_for(key, p.device)
    cd = _compute_dtype(p.dtype)
    return _unit(key, 0, p.numel(), cd).view(p.shape) < p.to(cd)


def randint(low: int, high: int, shape, dtype=torch.int64, device=None,
            key=None) -> torch.Tensor:
    """Integers in ``[low, high)``: ``low + (bits · r) >> 32`` for a
    range ``r <= 2³¹``, else two words modulo ``r``."""
    shape = _shape_of(shape)
    r = int(high) - int(low)
    if r <= 0:
        raise ValueError(f"randint: high {high} must exceed low {low}")
    key = _key_for(key, device)
    n = math.prod(shape)
    if r <= 1 << 31:
        v = (_index_bits(key, 0, n) * r) >> 32
    else:
        v = (((_index_bits(key, 0, n) & 0x3FFFFFFF) << 32)
             | _index_bits(key, n, n)) % r
    return (v + int(low)).to(dtype).view(shape)


def permutation(n: int, dtype=torch.int64, device=None,
                key=None) -> torch.Tensor:
    """A permutation of ``range(n)``: the argsort of ``n`` distinct
    words (the hash is a bijection of the index)."""
    key = _key_for(key, device)
    return torch.argsort(_words(key, 0, int(n))).to(dtype)


def exponential(shape, lam=1.0, dtype=torch.float32, device=None,
                key=None) -> torch.Tensor:
    """Exponential draws of rate ``lam``: ``-ln(1 - u) / lam``."""
    shape = _shape_of(shape)
    key = _key_for(key, device)
    cd = _compute_dtype(dtype)
    u = _unit(key, 0, math.prod(shape), cd)
    return (-torch.log1p(-u) / lam).to(dtype).view(shape)


def gumbel(shape, dtype=torch.float32, device=None,
           key=None) -> torch.Tensor:
    """Standard Gumbel draws: ``-ln(-ln u)`` with ``u`` in (0, 1)."""
    shape = _shape_of(shape)
    key = _key_for(key, device)
    cd = _compute_dtype(dtype)
    u = _unit(key, 0, math.prod(shape), cd, open_low=True)
    return (-torch.log(-torch.log(u))).to(dtype).view(shape)


def multinomial(probs: torch.Tensor, num_samples: int = 1,
                replacement: bool = False, key=None) -> torch.Tensor:
    """Category ids (int64) drawn from the rows of ``probs`` (``[K]``
    or ``[N, K]``, unnormalised weights). With replacement: the inverse
    CDF of one uniform a sample; without: the Gumbel top-k of
    ``ln p``, as ``jax.random.categorical`` draws."""
    key = _key_for(key, probs.device)
    p = probs.to(_compute_dtype(probs.dtype))
    k = p.shape[-1]
    rows = p.reshape(-1, k)
    if replacement:
        cdf = torch.cumsum(rows, -1)
        cdf = cdf / cdf[:, -1:]
        u = _unit(key, 0, rows.shape[0] * num_samples, p.dtype)
        idx = torch.searchsorted(cdf, u.view(rows.shape[0], num_samples),
                                 right=True).clamp_(max=k - 1)
    else:
        if num_samples > k:
            raise ValueError(f"multinomial: {num_samples} samples without "
                             f"replacement from {k} categories")
        u = _unit(key, 0, rows.numel(), p.dtype, open_low=True)
        g = -torch.log(-torch.log(u)).view(rows.shape)
        idx = torch.topk(torch.log(rows) + g, num_samples, -1).indices
    return idx.view(p.shape[:-1] + (num_samples,))


# -- host draws ---------------------------------------------------------------

_draws = 0


def draws() -> int:
    """How many host draws (:func:`generator_for`,
    :func:`device_generator`) the default generator has served."""
    return _draws


def _host_seed() -> int:
    global _draws
    if _key_observer is not None:
        _key_observer()
    _draws += 1
    lo, hi = _default_generator._host_key()
    return lo | hi << 32


def host_key() -> torch.Tensor:
    """The next key of the default generator as a CPU tensor, counted
    as a host draw: for the draws whose values shape host-side work
    (fractional pooling's windows, sampled class centres), which a
    graph would freeze."""
    s = _host_seed()
    return torch.tensor([s & _M32, s >> 32], dtype=torch.int64)


def device_generator(device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by a host draw (the
    rejection samplers' and the ``io`` samplers' generator)."""
    return torch.Generator(device=device).manual_seed(_host_seed())


def generator_for(device) -> torch.Generator:
    """A ``torch.Generator`` for a host-seeded random op on ``device``,
    seeded by a host draw of the default generator."""
    return device_generator(torch.device(device))
