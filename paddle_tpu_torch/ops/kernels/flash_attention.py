"""Flash attention: the Hopper kernels, their plain versions, autograd.

Replaces the TPU kernels of ``paddle_tpu/ops/pallas/flash_attention.py``
(``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``, with their
dropout keep mask ``_keep_mask`` and their segment mask) and the
``custom_vjp`` around them. Tensors are ``[B, L, H, D]`` (the paddle
flash-attention layout) or ``[BH, L, D]`` (the TPU's transposed layout,
taken as ``H = 1``); ``lse`` and ``delta`` are f32 ``[B, H, L]``
(``[BH, L]`` for 3-D inputs); ``seg`` is int32 ``[B, L]`` (``[BH, L]``).

Three wrappers launch the CUDA kernels on CUDA tensors; a CPU tensor
takes the plain version of the same function (and counts nothing).
Two designs share each wrapper, and :func:`takes_tma` picks one before
the launch from the operands alone: bf16 at head dim 64 or 128, with
segments or dropout but not both, dropout at head dim 64 only, with
bases and strides a TMA tensor map can describe, goes to the TMA /
``wgmma`` kernels of ``csrc/flash_attention_tma.cu``; everything else
to the first design, ``csrc/flash_attention.cuh``. Both draw the keep
mask of ``csrc/philox.cuh``. Each wrapper counts every launch
(``.launches``), those of the TMA design (``.tma_launches``) and, apart,
each launch with dropout and each with segments, in either design.
There is no fallback: a CUDA call the chosen kernel refuses raises:

- :func:`flash_attention_fwd` -> ``(out, lse)``; plain version
  :func:`flash_attention_fwd_reference`, a tiled online-softmax walk;
- :func:`flash_attention_bwd_dq` -> ``dq``; plain version
  :func:`flash_attention_bwd_dq_reference`;
- :func:`flash_attention_bwd_dkv` -> ``(dk, dv)``; plain version
  :func:`flash_attention_bwd_dkv_reference`.

:func:`flash_attention_bwd_reference` is the whole plain backward
(Δ = rowsum(dO∘O) in f32, then both parts). :func:`flash_fwd_op` is the
forward as the ``torch.library`` operator ``paddle_tpu_torch::flash_fwd``
(a fake kernel gives its output shapes), registered when this module is
imported: ``torch.export`` keeps it in an exported program (it cannot
trace a ``ctypes`` call), and a process that loads the program imports
this module first. :class:`FlashAttention` is
the ``torch.autograd.Function``: forward runs that operator, saves ``(q, k, v, out, lse)``
(and the segment ids and the dropout key), backward computes Δ outside
the kernels and launches dQ and dK/dV, which regenerate the forward's
keep mask from the same key. :func:`flash_attention` and
:func:`flash_attention_segmented` are the public entries.

Lengths: k and v (and dK, dV) may differ from q (and out, dO, dQ) in
the sequence dimension alone, ``Lk`` keys against ``L`` queries
(cross-attention, a KV-cache step, a chunk against its history). Causal
puts the diagonal where the JAX oracle ``_sdpa_xla`` does: query row i
sees the keys j <= i + Lk - L. A causal row with no allowed key (i < L -
Lk) is written as zeros by the kernels and their plain versions (lse
-1e30); :class:`FlashAttention` then gives it ``_sdpa_xla``'s answer, the
(kept) mean of V's rows, and its gradient (:func:`_empty_rows`).
Segments need ``Lk = L``.

Numerics (the TPU kernels'): every product accumulates in f32 over
operands in the input dtype (the plain versions multiply f32 copies of
those operands, which is the same arithmetic up to summation order);
P is rounded to V's dtype before PV, dS to K's / Q's dtype before its
products; softmax statistics are f32 and come from the undropped P; a
masked logit is -1e30 and masked probabilities are exactly zero;
``out = acc / (1 - p) / max(l, 1e-30)`` and
``lse = m + log(max(l, 1e-30))``. Any ``L >= 1`` is taken: the ragged
tail is masked (the JAX entry instead falls back to XLA for shapes that
do not tile).

Segments: ``seg`` is the int32 ids ``[B, L]`` or a :class:`SegmentPlan`
of them, which holds what the kernels read beside the ids (each 32-row
chunk's id range; the TMA kernels' window of tiles a CTA walks,
:func:`segment_windows`), built once on the device and reused by the
launches of a step.

Dropout: the keep mask is a pure function of ``(seed, b, h, row, col)``
— Philox4x32-10 (:func:`philox4x32_10`) keyed by the two words of the
seed, on the counter ``(col >> 2, row, b·H + h, 0)``, word ``col & 3``; a
pair is kept iff that word is at least ``min(floor(p·2³²), 2³²−1)``. The
seed of a launch is a key tensor (int64 ``[2]`` on the inputs' device,
``core.random.next_key``): the kernels read its words from device
memory, so a CUDA graph that holds the launch draws a fresh mask on
every replay. The plain versions take a key tensor too, or, in tests, a
Python int (its low and high 32-bit words). The kernels and the plain
versions draw the same bits, whatever their tiles;
:func:`flash_dropout_keep_mask` returns the whole mask. It is not the
TPU's bit stream (``pltpu.prng_random_bits``), which no other device
reproduces.
"""
from __future__ import annotations

import ctypes
import math
import numbers
from typing import Dict, Optional, Tuple, Union

import torch

from . import build as _build

__all__ = ["FlashAttention", "flash_attention", "flash_attention_segmented",
           "flash_attention_fwd", "flash_fwd_op", "flash_attention_bwd", "takes_tma",
           "SegmentPlan", "segment_windows",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_fwd_reference", "flash_attention_bwd_reference",
           "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference", "attention_delta",
           "philox4x32_10", "flash_dropout_keep_mask", "dropout_threshold"]

_NEG_INF = -1e30
_BLOCK = 64                        # the plain walk's KV tile (the kernels')
_CHUNK = 32                        # rows of one segment-range entry
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_HEAD_DIMS = (64, 128)
_M32 = 0xFFFFFFFF
_libs: Dict[Tuple[torch.dtype, int], ctypes.CDLL] = {}
_tma_lib: Optional[ctypes.CDLL] = None
_TMA_HEAD_DIMS = (64, 128)         # the head dims the TMA design is built for
_TMA_DROPOUT_HEAD_DIM = 64         # ... and the one it takes dropout at
_INT32_MAX = 2 ** 31 - 1
_TMA_KERNELS = ("fwd", "dq", "dkv")  # the TMA library's kernel codes
_tma_tiles_of: Dict[Tuple[str, int], Tuple[int, int]] = {}


def _scale(d: int, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def _as4(x: torch.Tensor) -> torch.Tensor:
    """``[B, L, H, D]`` as is; ``[BH, L, D]`` as the view ``[BH, L, 1, D]``."""
    if x.dim() == 3:
        return x.unsqueeze(2)
    if x.dim() != 4:
        raise ValueError(f"flash attention takes [B, L, H, D] or "
                         f"[BH, L, D], got {tuple(x.shape)}")
    return x


def _acc(x: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulation dtype: f32 (f64 for f64 inputs,
    which only the CPU takes: gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``[B, L, H, D]`` -> ``[B, H, L, D]`` in the accumulation dtype (an
    exact copy of the input dtype's values)."""
    return x.permute(0, 2, 1, 3).to(_acc(x))


def _lse_shape(q: torch.Tensor, lse4: torch.Tensor) -> torch.Tensor:
    """``[B, H, L]`` back to ``[BH, L]`` for 3-D inputs."""
    return lse4[:, 0] if q.dim() == 3 else lse4


def _lse4(q: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    return lse.unsqueeze(1) if q.dim() == 3 else lse


# ---------------------------------------------------------------------------
# the dropout keep mask
# ---------------------------------------------------------------------------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of ``a * m`` for ``a`` in [0, 2³²): the
    int64 product wraps, but its low 64 bits are exact; ``>>`` is
    arithmetic, so the high word is masked."""
    prod = a * m
    return (prod >> 32) & _M32, prod & _M32


def philox4x32_10(ctr, key):
    """Philox4x32-10 (the Random123 constants) on int64 tensors holding
    unsigned 32-bit words: ``ctr`` four broadcastable tensors (or ints),
    ``key`` two words, ints or 0-dim int64 tensors (a key tensor's, on
    the counters' device). Returns the four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = (k & _M32 if isinstance(k, torch.Tensor) else int(k) & _M32
              for k in key)
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _M32
        k1 = (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def dropout_threshold(p: float) -> int:
    """The keep threshold of the TPU kernels' ``_keep_mask``: a word is
    kept iff it is at least ``min(floor(p·2³²), 2³²−1)``."""
    return min(int(p * (2 ** 32)), 2 ** 32 - 1)


def _is_key(seed) -> bool:
    return isinstance(seed, torch.Tensor) and seed.dtype == torch.int64 \
        and seed.numel() == 2


def _seed_words(seed):
    """The two Philox key words of ``seed``: a key tensor's as 0-dim
    tensors on its device, a Python int's (tests) as ints."""
    if isinstance(seed, torch.Tensor):
        if not _is_key(seed):
            raise TypeError(f"the dropout key is an int64 [2] tensor, got "
                            f"{seed.dtype} {tuple(seed.shape)}")
        w = seed.reshape(2)
        return w[0], w[1]
    if not isinstance(seed, numbers.Integral):
        raise TypeError(f"the dropout seed is a key tensor "
                        f"(core.random.next_key), got {type(seed).__name__}")
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s & _M32, s >> 32


def _key_ptr(seed, device: torch.device, name: str) -> int:
    """The device address of a launch's key: an int64 [2] contiguous
    tensor on the inputs' ``device``, which the kernels read."""
    if not _is_key(seed) or not seed.is_contiguous():
        raise TypeError(f"{name}: the dropout key is a contiguous int64 [2] "
                        f"tensor (core.random.next_key), got "
                        f"{type(seed).__name__}")
    if seed.device != device:
        raise ValueError(f"{name}: the dropout key lies on {seed.device}, "
                         f"the inputs on {device}")
    return seed.data_ptr()


def _keep_tile(seed, B: int, H: int, rows: torch.Tensor, c0: int,
               n: int, thresh: int) -> torch.Tensor:
    """Keep bits of rows ``rows`` x columns ``c0 .. c0 + n - 1``:
    ``[B, H, len(rows), n]`` bool."""
    dev = rows.device
    lo, hi = (w.to(dev) if isinstance(w, torch.Tensor) else w
              for w in _seed_words(seed))
    g0, g1 = c0 >> 2, ((c0 + n - 1) >> 2) + 1
    grp = torch.arange(g0, g1, dtype=torch.int64, device=dev)
    bh = torch.arange(B * H, dtype=torch.int64, device=dev)
    words = philox4x32_10((grp[None, None, :], rows.long()[None, :, None],
                           bh[:, None, None], 0), (lo, hi))
    w = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    w = w.reshape(B * H, rows.numel(), -1)
    off = c0 - 4 * g0
    return (w[..., off:off + n] >= thresh).view(B, H, rows.numel(), n)


def flash_dropout_keep_mask(seed, B: int, H: int, L: int, p: float,
                            device=None, Lk: Optional[int] = None
                            ) -> torch.Tensor:
    """The kernels' whole keep mask, ``[B, H, L, Lk]`` bool (query row,
    key column; ``Lk`` defaults to ``L``), on ``device`` (a key tensor's
    device by default)."""
    Lk = L if Lk is None else Lk
    if device is None and isinstance(seed, torch.Tensor):
        device = seed.device
    rows = torch.arange(L, device=device)
    return _keep_tile(seed, B, H, rows, 0, Lk, dropout_threshold(p))


def _dropout_args(dropout_p: float, seed) -> Tuple[int, float]:
    """(threshold, 1 / (1 - p)) of a launch; (0, 1.0) without dropout."""
    if dropout_p <= 0.0:
        return 0, 1.0
    if dropout_p >= 1.0:
        raise ValueError("flash attention dropout_p must be < 1 (p = 1 "
                         "zeroes the output: handle it at the call site)")
    if seed is None:
        raise ValueError("flash attention dropout needs a seed (a key "
                         "tensor from core.random.next_key)")
    _seed_words(seed)
    return dropout_threshold(dropout_p), 1.0 / (1.0 - dropout_p)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _ok(rows: torch.Tensor, cols: torch.Tensor, Lk: int, causal: bool,
        seg: Optional[torch.Tensor], off: int = 0) -> torch.Tensor:
    """Allowed pairs, broadcastable to ``[B, H, len(rows), len(cols)]``:
    columns inside Lk, at or before the row's diagonal (its index +
    ``off``, ``Lk - L``) when causal, in the row's segment."""
    ok = (cols < Lk)[None, :].expand(rows.numel(), -1)
    if causal:
        ok = ok & (cols[None, :] <= rows[:, None] + off)
    ok = ok[None, None]
    if seg is not None:
        sc = seg[:, cols.clamp(max=Lk - 1)]
        ok = ok & (seg[:, rows, None] == sc[:, None, :])[:, None]
    return ok


def _check_seg(seg: Optional[torch.Tensor], B: int, L: int, device,
               Lk: Optional[int] = None):
    if seg is None:
        return
    if Lk is not None and Lk != L:
        raise ValueError(f"segment ids index queries and keys alike: "
                         f"{L} queries against {Lk} keys")
    if seg.dtype != torch.int32 or tuple(seg.shape) != (B, L) \
            or seg.device != device:
        raise ValueError(f"seg must be int32 [B, L] = [{B}, {L}] on "
                         f"{device}, got {seg.dtype} {tuple(seg.shape)} "
                         f"on {seg.device}")


def flash_attention_fwd_reference(q, k, v, causal: bool = False,
                                  scale: Optional[float] = None,
                                  dropout_p: float = 0.0,
                                  seed=None,
                                  seg: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: an online-softmax walk over KV tiles of the
    kernel's width with the kernel's roundings and keep mask. Returns
    ``(out, lse)``."""
    q4, k4, v4 = _as4(q), _as4(k), _as4(v)
    B, L, H, D = q4.shape
    Lk = k4.shape[1]
    _check_seg(seg, B, L, q.device, Lk)
    thresh, inv = _dropout_args(dropout_p, seed)
    s = _scale(D, scale)
    qf = _rows(q4)
    acc_t = qf.dtype
    rows = torch.arange(L, device=q.device)
    m = torch.full((B, H, L), _NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros((B, H, L), dtype=acc_t, device=q.device)
    acc = torch.zeros((B, H, L, D), dtype=acc_t, device=q.device)
    for k0 in range(0, Lk, _BLOCK):
        kb = _rows(k4[:, k0:k0 + _BLOCK])
        vb = _rows(v4[:, k0:k0 + _BLOCK])
        cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        ok = _ok(rows, cols, Lk, causal, seg, Lk - L)
        logits = torch.where(ok, (qf @ kb.transpose(-1, -2)) * s, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # re-masked: a row whose columns are all masked so far has
        # logits == m_new == -1e30 and exp() == 1
        p = torch.where(ok, torch.exp(logits - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)      # the undropped row sum
        if thresh:
            p = torch.where(_keep_tile(seed, B, H, rows, k0, cols.numel(),
                                       thresh), p, 0.0)
        acc = alpha[..., None] * acc + p.to(v.dtype).to(acc_t) @ vb
        m = m_new
    lm = l.clamp(min=1e-30)
    if thresh:
        acc = acc * inv
    out = (acc / lm[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    lse = m + torch.log(lm)
    return out.reshape(q.shape).contiguous(), _lse_shape(q, lse)


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO∘O) in f32, ``[B, H, L]`` (``[BH, L]`` for 3-D)."""
    acc_t = _acc(out)
    d = (do.to(acc_t) * out.to(acc_t)).sum(dim=-1)     # [B, L, H]/[BH, L]
    return d.transpose(1, 2).contiguous() if out.dim() == 4 else d


def _bwd_tiles(q, k, v, do, lse, delta, causal, scale, dropout_p, seed,
               seg):
    """Yield, per KV tile, ``(kb, p_d, ds)`` with
    P = exp(scale·QKᵀ − lse) (masked), the dropped P_d = keep∘P/(1−p)
    and dS = P∘(keep∘dO Vᵀ/(1−p) − Δ)·scale, f32 ``[B, H, L, 64]`` (the
    last tile narrower when 64 does not divide Lk) — the
    algebra of the TPU backward kernels."""
    q4, k4, v4, do4 = _as4(q), _as4(k), _as4(v), _as4(do)
    B, L, H, D = q4.shape
    Lk = k4.shape[1]
    _check_seg(seg, B, L, q.device, Lk)
    thresh, inv = _dropout_args(dropout_p, seed)
    s = _scale(D, scale)
    qf, dof = _rows(q4), _rows(do4)
    lse4 = _lse4(q, lse).to(qf.dtype)[..., None]
    dl4 = _lse4(q, delta).to(qf.dtype)[..., None]
    rows = torch.arange(L, device=q.device)
    for k0 in range(0, Lk, _BLOCK):
        kb = _rows(k4[:, k0:k0 + _BLOCK])
        vb = _rows(v4[:, k0:k0 + _BLOCK])
        cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        ok = _ok(rows, cols, Lk, causal, seg, Lk - L)
        p = torch.where(ok, torch.exp(s * (qf @ kb.transpose(-1, -2))
                                      - lse4), 0.0)
        dp = dof @ vb.transpose(-1, -2)
        p_d = p
        if thresh:
            keep = _keep_tile(seed, B, H, rows, k0, cols.numel(), thresh)
            p_d = torch.where(keep, p * inv, 0.0)
            dp = torch.where(keep, dp * inv, 0.0)
        ds = p * (dp - dl4) * s
        yield kb, p_d, ds


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                     causal: bool = False,
                                     scale: Optional[float] = None,
                                     dropout_p: float = 0.0,
                                     seed=None,
                                     seg: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """The dQ kernel's function in plain PyTorch: dQ = Σ_tiles dS K with
    dS rounded to K's dtype."""
    dq = None
    for kb, _, ds in _bwd_tiles(q, k, v, do, lse, delta, causal, scale,
                                dropout_p, seed, seg):
        part = ds.to(k.dtype).to(kb.dtype) @ kb
        dq = part if dq is None else dq + part
    return dq.permute(0, 2, 1, 3).to(q.dtype).reshape(q.shape).contiguous()


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                      causal: bool = False,
                                      scale: Optional[float] = None,
                                      dropout_p: float = 0.0,
                                      seed=None,
                                      seg: Optional[torch.Tensor] = None
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's function in plain PyTorch: per KV tile,
    dV = P_dᵀ dO and dK = dSᵀ Q (P_d, dS rounded to dO's / Q's dtype)."""
    qf, dof = _rows(_as4(q)), _rows(_as4(do))
    dks, dvs = [], []
    for _, p_d, ds in _bwd_tiles(q, k, v, do, lse, delta, causal, scale,
                                 dropout_p, seed, seg):
        dvs.append(p_d.to(do.dtype).to(dof.dtype).transpose(-1, -2) @ dof)
        dks.append(ds.to(q.dtype).to(qf.dtype).transpose(-1, -2) @ qf)
    dk = torch.cat(dks, dim=2).permute(0, 2, 1, 3).to(k.dtype)
    dv = torch.cat(dvs, dim=2).permute(0, 2, 1, 3).to(v.dtype)
    return dk.reshape(k.shape).contiguous(), dv.reshape(v.shape).contiguous()


def flash_attention_bwd_reference(q, k, v, out, lse, do,
                                  causal: bool = False,
                                  scale: Optional[float] = None,
                                  dropout_p: float = 0.0,
                                  seed=None,
                                  seg: Optional[torch.Tensor] = None):
    """The whole plain backward: Δ, then dQ and dK/dV. -> (dq, dk, dv)."""
    delta = attention_delta(out, do)
    extra = (dropout_p, seed, seg)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                          scale, *extra)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               causal, scale, *extra)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _kernel_lib(dtype: torch.dtype, d: int) -> ctypes.CDLL:
    """The library of one (dtype, head dim): the four build in parallel
    from ``csrc/flash_attention_<dtype>_d<D>.cu``."""
    lib = _libs.get((dtype, d))
    if lib is None:
        lib = _build.load(f"flash_attention_{_DTYPE_NAMES[dtype]}_d{d}")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        tail = [p, i, i, i, i, i, i, ctypes.c_float, i,
                p, ctypes.c_longlong, p, p, u, ctypes.c_float, p]
        lib.flash_attention_forward.argtypes = [p] * 5 + tail
        lib.flash_attention_backward_dq.argtypes = [p] * 7 + tail
        lib.flash_attention_backward_dkv.argtypes = [p] * 8 + tail
        for fn in (lib.flash_attention_forward,
                   lib.flash_attention_backward_dq,
                   lib.flash_attention_backward_dkv):
            fn.restype = ctypes.c_int
        _libs[(dtype, d)] = lib
    return lib


def _kernel_lib_tma() -> ctypes.CDLL:
    """The TMA / ``wgmma`` design's library, ``csrc/flash_attention_tma.cu``
    (bf16, head dim 64 or 128)."""
    global _tma_lib
    if _tma_lib is None:
        lib = _build.load("flash_attention_tma")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        tail = [p, i, i, i, i, i, i, ctypes.c_float, p, ctypes.c_longlong,
                p, p, p, u, ctypes.c_float, p]
        lib.flash_attention_tma_forward.argtypes = [p] * 5 + tail
        lib.flash_attention_tma_backward_dq.argtypes = [p] * 7 + tail
        lib.flash_attention_tma_backward_dkv.argtypes = [p] * 8 + tail
        lib.flash_attention_tma_tiles.argtypes = [i, i, p, p]
        for fn in (lib.flash_attention_tma_forward,
                   lib.flash_attention_tma_backward_dq,
                   lib.flash_attention_tma_backward_dkv,
                   lib.flash_attention_tma_tiles):
            fn.restype = ctypes.c_int
        _tma_lib = lib
    return _tma_lib


def _tma_tiles(kernel: str, d: int) -> Tuple[int, int]:
    """(rows a CTA owns, rows of the other operand's tile) of a TMA kernel
    ("fwd", "dq", "dkv") at head dim ``d``, as the library sizes them: the
    units of its windows (forward and dQ blocks of queries over key
    tiles, dK/dV blocks of keys over query stages)."""
    key = (kernel, d)
    if key not in _tma_tiles_of:
        block, tile = ctypes.c_int(), ctypes.c_int()
        if _kernel_lib_tma().flash_attention_tma_tiles(
                _TMA_KERNELS.index(kernel), d, ctypes.byref(block),
                ctypes.byref(tile)):
            raise ValueError(f"no TMA kernel {kernel} at head dim {d}")
        _tma_tiles_of[key] = (block.value, tile.value)
    return _tma_tiles_of[key]


def takes_tma(q, k, v, do=None, *, dropout_p: float = 0.0,
              seg=None) -> bool:
    """Whether the TMA / ``wgmma`` kernels take a call, from the operands'
    dtype, shapes, alignment and strides alone (nothing is launched).

    They take ``q``, ``k``, ``v`` (and the backward's ``do``) in bf16,
    ``[B, L, H, D]`` or ``[BH, L, D]``, ``k`` and ``v`` of one shape that
    differs from q's (and ``do``'s) in L alone, with head dim 64 or 128
    contiguous; with dropout at head dim 64 only, or with segments
    (``seg`` int32 ``[B, L]`` with contiguous rows, or its
    :class:`SegmentPlan`, keys as many as queries) without dropout: each
    flag set has its own
    instance, and no public entry combines the two (the varlen entry
    takes no dropout); every base 16-byte aligned and every (batch, seq,
    head) stride a multiple of 8 elements (16 bytes), so that a TMA
    tensor map describes each tensor in place (q, k, v may be strided
    views of one projection, as the varlen entry's packed
    ``[total, 3, H, D]`` is); and sizes inside the grid's and the
    kernels' 32-bit ranges."""
    ts = [t for t in (q, k, v, do) if t is not None]
    if any(t.dtype != torch.bfloat16 for t in ts) or not _lengths_only(
            q, k, v, do):
        return False
    if q.dim() not in (3, 4) or q.shape[-1] not in _TMA_HEAD_DIMS \
            or q.numel() == 0 or k.numel() == 0:
        return False
    if dropout_p > 0.0 and q.shape[-1] != _TMA_DROPOUT_HEAD_DIM:
        return False
    B, L, H, _ = _as4(q).shape
    Lk = k.shape[1]
    ids = _ids(seg)
    if ids is not None and (dropout_p > 0.0 or ids.dtype != torch.int32
                            or tuple(ids.shape) != (B, L) or Lk != L
                            or ids.stride(1) != 1 or ids.device != q.device):
        return False
    if B > 65535 or H > 65535 or B * H * max(L, Lk) > _INT32_MAX:
        return False
    return all(_as4(t).stride(3) == 1 and t.data_ptr() % 16 == 0
               and all(x % 8 == 0 for x in _as4(t).stride()[:3])
               for t in ts)


def _lengths_only(q, k, v, do=None) -> bool:
    """Whether ``k`` and ``v`` share one shape that differs from ``q``'s
    in the sequence dimension alone, and ``do`` (if given) is shaped like
    ``q``."""
    return (k.shape == v.shape and k.dim() == q.dim()
            and k.shape[:1] == q.shape[:1] and k.shape[2:] == q.shape[2:]
            and (do is None or do.shape == q.shape))


def _check(name: str, q, tensors, f32s=(), seg=None
           ) -> Tuple[int, int, int, int, int]:
    """Device, dtype, shape, stride and alignment checks of a launch
    (``tensors`` is q, k, v and the backward's dO); returns ``(B, L, Lk,
    H, D)``."""
    def need(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")

    need(q.dtype in _DTYPE_CODES,
         f"dtype {q.dtype} (float32 or bfloat16)")
    q4 = _as4(q)
    B, L, H, D = q4.shape
    need(D in _HEAD_DIMS, f"head dim {D} not in {_HEAD_DIMS}")
    k = tensors[1]
    need(_lengths_only(*tensors),
         f"shapes differ beyond the sequence length: q "
         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
         f"{tuple(tensors[2].shape)}" + (
             f", do {tuple(tensors[3].shape)}" if len(tensors) > 3 else ""))
    Lk = k.shape[1]
    need(Lk > 0, "no keys")
    need(seg is None or Lk == L,
         f"segment ids index queries and keys alike: {L} queries against "
         f"{Lk} keys")
    need(B * H * Lk <= _INT32_MAX, f"{B * H * Lk} key rows overflow int32")
    vec = 16 // q.element_size()
    for t in tensors:
        need(t.dtype == q.dtype, f"dtypes differ: {t.dtype} vs {q.dtype}")
        need(t.device == q.device, "all tensors on one device")
        t4 = _as4(t)
        need(t4.stride(3) == 1, "the head dim must be contiguous")
        need(all(st % vec == 0 for st in t4.stride()[:3])
             and t.data_ptr() % 16 == 0,
             "rows must be 16-byte aligned (strides a multiple of "
             f"{vec} elements)")
    for t in f32s:
        need(t.dtype == torch.float32 and t.device == q.device
             and t.is_contiguous() and t.numel() == B * H * L,
             f"lse/delta must be contiguous float32 with {B * H * L} "
             f"elements on {q.device}, got {t.dtype} {tuple(t.shape)}")
    if seg is not None:
        need(seg.dtype == torch.int32 and tuple(seg.shape) == (B, L)
             and seg.device == q.device and seg.stride(1) == 1,
             f"seg must be int32 [B, L] = [{B}, {L}] with contiguous "
             f"rows on {q.device}, got {seg.dtype} {tuple(seg.shape)}")
    return B, L, Lk, H, D


def _strides(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in _as4(t).stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _seg_ranges(seg: torch.Tensor) -> torch.Tensor:
    """``[B, ceil(L / 32), 2]`` int32: the least and largest segment id of
    every 32-row chunk (the kernels skip a tile whose range is disjoint
    from theirs)."""
    B, L = seg.shape
    pad = -L % _CHUNK
    if pad:
        seg = torch.cat([seg, seg[:, -1:].expand(B, pad)], dim=1)
    c = seg.reshape(B, -1, _CHUNK)
    return torch.stack([c.amin(dim=2), c.amax(dim=2)], dim=2).contiguous()


def _group_ranges(rng: torch.Tensor, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(least, largest) id ``[B, ceil(C / n)]`` of each group of ``n``
    consecutive chunks of ``rng`` ``[B, C, 2]`` (the last group padded
    with the last chunk)."""
    lo, hi = rng[..., 0], rng[..., 1]
    pad = -lo.shape[1] % n
    if pad:
        lo = torch.cat([lo, lo[:, -1:].expand(-1, pad)], dim=1)
        hi = torch.cat([hi, hi[:, -1:].expand(-1, pad)], dim=1)
    B = lo.shape[0]
    return lo.reshape(B, -1, n).amin(dim=2), hi.reshape(B, -1, n).amax(dim=2)


def segment_windows(rng: torch.Tensor, block_rows: int, tile_rows: int,
                    causal: bool, rows_are_keys: bool = False
                    ) -> torch.Tensor:
    """The window of tiles each CTA of the TMA kernels walks:
    ``[B, ceil(L / block_rows), 2]`` int32, for each block of
    ``block_rows`` rows (queries; keys when ``rows_are_keys``) the first
    tile of ``tile_rows`` rows of the other operand and one past the last
    whose chunk id ranges (``rng``, :func:`_seg_ranges`) overlap the
    block's; causal clips it at the diagonal (key tiles that start after
    the block's last query, query tiles that end before its first key).
    Every allowed pair lies inside its block's window, whatever the ids;
    for sorted ids (every varlen call) the window is exact: its first
    and last tiles hold allowed pairs. Plain torch on the ids' device, no
    host sync; both sizes are multiples of 32."""
    blo, bhi = _group_ranges(rng, block_rows // _CHUNK)
    tlo, thi = _group_ranges(rng, tile_rows // _CHUNK)
    hit = (tlo[:, None, :] <= bhi[:, :, None]) & \
        (thi[:, None, :] >= blo[:, :, None])          # [B, blocks, tiles]
    if causal:
        blk = torch.arange(blo.shape[1], device=rng.device)[:, None]
        t = torch.arange(tlo.shape[1], device=rng.device)[None, :]
        hit &= ((t + 1) * tile_rows > blk * block_rows) if rows_are_keys \
            else (t * tile_rows < (blk + 1) * block_rows)
    n = hit.shape[2]
    first = hit.to(torch.uint8).argmax(dim=2)
    end = n - hit.flip(2).to(torch.uint8).argmax(dim=2)
    some = hit.any(dim=2)
    return torch.stack([torch.where(some, first, 0),
                        torch.where(some, end, 0)], dim=2) \
        .to(torch.int32).contiguous()


class SegmentPlan:
    """Segment ids ``[B, L]`` (int32, contiguous rows) with what the
    kernels read beside them, built once on the ids' device and reused by
    the three launches of a step: ``ranges``, each 32-row chunk's least
    and largest id (both designs), and the TMA kernels' windows
    (:func:`segment_windows`), built at a kernel's first call and kept."""

    def __init__(self, ids: torch.Tensor,
                 ranges: Optional[torch.Tensor] = None):
        self.ids = ids
        self.ranges = _seg_ranges(ids) if ranges is None else ranges
        self._windows: Dict[Tuple[int, int, bool, bool], torch.Tensor] = {}

    def window(self, kernel: str, d: int, causal: bool) -> torch.Tensor:
        """The windows of one TMA kernel ("fwd", "dq" or "dkv") at head
        dim ``d``."""
        block, tile = _tma_tiles(kernel, d)
        key = (block, tile, bool(causal), kernel == "dkv")
        if key not in self._windows:
            self._windows[key] = segment_windows(self.ranges, *key)
        return self._windows[key]


# a wrapper's ``seg``: the ids, their plan, or None
Segments = Optional[Union[torch.Tensor, SegmentPlan]]


def _plan(seg: Segments) -> Optional[SegmentPlan]:
    if seg is None or isinstance(seg, SegmentPlan):
        return seg
    return SegmentPlan(seg)


def _ids(seg: Segments) -> Optional[torch.Tensor]:
    return seg.ids if isinstance(seg, SegmentPlan) else seg


def _launch(wrapper, fn, name, args, shape, causal, scale, dtype, device,
            dropout_p, seed, seg: Optional[SegmentPlan]):
    B, L, Lk, H, D = shape
    thresh, inv = _dropout_args(dropout_p, seed)
    key = _key_ptr(seed, device, name) if thresh else None
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, B, L, Lk, H, D, int(bool(causal)), scale,
            _DTYPE_CODES[dtype],
            seg.ids.data_ptr() if seg is not None else None,
            seg.ids.stride(0) if seg is not None else 0,
            seg.ranges.data_ptr() if seg is not None else None,
            key, thresh, inv, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError "
                           f"{rc} (B={B} L={L} Lk={Lk} H={H} D={D} {dtype} "
                           f"causal={bool(causal)} dropout_p={dropout_p} "
                           f"segments={seg is not None})")
    wrapper.launches += 1
    wrapper.dropout_launches += bool(thresh)
    wrapper.segmented_launches += seg is not None


def _launch_tma(wrapper, fn, name, kernel, args, shape, causal, scale,
                device, dropout_p, seed, seg: Optional[SegmentPlan]):
    """A launch of the TMA design (``takes_tma`` accepted the call): the
    C entry re-checks and returns an error, which raises here. p = 0
    takes the instance without dropout; segments take theirs, with the
    windows of ``kernel`` ("fwd", "dq", "dkv")."""
    B, L, Lk, H, D = shape
    thresh, inv = _dropout_args(dropout_p, seed)
    key = _key_ptr(seed, device, name) if thresh else None
    win = seg.window(kernel, D, causal) if seg is not None else None
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, B, L, Lk, H, D, int(bool(causal)), scale,
            seg.ids.data_ptr() if seg is not None else None,
            seg.ids.stride(0) if seg is not None else 0,
            seg.ranges.data_ptr() if seg is not None else None,
            win.data_ptr() if win is not None else None,
            key, thresh, inv, stream)
    if rc != 0:
        what = "cuTensorMapEncodeTiled refused a tensor map" if rc == -1 \
            else f"kernel launch failed with cudaError {rc}"
        raise RuntimeError(f"{name}: TMA {what} (B={B} L={L} Lk={Lk} H={H} "
                           f"D={D} "
                           f"causal={bool(causal)} dropout_p={dropout_p} "
                           f"segments={seg is not None})")
    wrapper.launches += 1
    wrapper.tma_launches += 1
    wrapper.dropout_launches += bool(thresh)
    wrapper.segmented_launches += seg is not None


def _on(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU tensor (plain)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        dropout_p: float = 0.0, seed=None,
                        seg: Segments = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors (the plain walk for CPU
    tensors). -> ``(out, lse)``."""
    name = "flash_attention_fwd"
    if not _on(q, name):
        return flash_attention_fwd_reference(q, k, v, causal, scale,
                                             dropout_p, seed, _ids(seg))
    shape = _check(name, q, (q, k, v), seg=_ids(seg))
    seg = _plan(seg)
    s = _scale(shape[4], scale)
    out = torch.empty_like(q)
    lse = torch.empty((shape[0], shape[3], shape[1]), dtype=torch.float32,
                      device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _strides(q, k, v, out))
    if takes_tma(q, k, v, dropout_p=dropout_p, seg=seg):
        _launch_tma(flash_attention_fwd,
                    _kernel_lib_tma().flash_attention_tma_forward, name,
                    "fwd", args, shape, causal, s, q.device, dropout_p,
                    seed, seg)
    else:
        _launch(flash_attention_fwd,
                _kernel_lib(q.dtype, shape[4]).flash_attention_forward, name,
                args, shape, causal, s, q.dtype, q.device, dropout_p, seed,
                seg)
    return out, _lse_shape(q, lse)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                           scale: Optional[float] = None,
                           dropout_p: float = 0.0,
                           seed=None,
                           seg: Segments = None
                           ) -> torch.Tensor:
    """Launch the dQ kernel on CUDA tensors (its plain version for CPU
    tensors)."""
    name = "flash_attention_bwd_dq"
    if not _on(q, name):
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal, scale, dropout_p,
                                                seed, _ids(seg))
    shape = _check(name, q, (q, k, v, do), (lse, delta), seg=_ids(seg))
    seg = _plan(seg)
    s = _scale(shape[4], scale)
    dq = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, do, dq))
    if takes_tma(q, k, v, do, dropout_p=dropout_p, seg=seg):
        _launch_tma(flash_attention_bwd_dq,
                    _kernel_lib_tma().flash_attention_tma_backward_dq, name,
                    "dq", args, shape, causal, s, q.device, dropout_p, seed,
                    seg)
    else:
        _launch(flash_attention_bwd_dq,
                _kernel_lib(q.dtype, shape[4]).flash_attention_backward_dq,
                name, args, shape, causal, s, q.dtype, q.device, dropout_p,
                seed, seg)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                            scale: Optional[float] = None,
                            dropout_p: float = 0.0,
                            seed=None,
                            seg: Segments = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel on CUDA tensors (its plain version for
    CPU tensors). -> ``(dk, dv)``."""
    name = "flash_attention_bwd_dkv"
    if not _on(q, name):
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, scale, dropout_p,
                                                 seed, _ids(seg))
    shape = _check(name, q, (q, k, v, do), (lse, delta), seg=_ids(seg))
    seg = _plan(seg)
    s = _scale(shape[4], scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, do, dk, dv))
    if takes_tma(q, k, v, do, dropout_p=dropout_p, seg=seg):
        _launch_tma(flash_attention_bwd_dkv,
                    _kernel_lib_tma().flash_attention_tma_backward_dkv, name,
                    "dkv", args, shape, causal, s, q.device, dropout_p, seed,
                    seg)
    else:
        _launch(flash_attention_bwd_dkv,
                _kernel_lib(q.dtype, shape[4]).flash_attention_backward_dkv,
                name, args, shape, causal, s, q.dtype, q.device, dropout_p,
                seed, seg)
    return dk, dv


for _w in (flash_attention_fwd, flash_attention_bwd_dq,
           flash_attention_bwd_dkv):
    _w.launches = 0             # every launch
    _w.tma_launches = 0         # those of the TMA / wgmma design
    _w.dropout_launches = _w.segmented_launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False,
                        scale: Optional[float] = None,
                        dropout_p: float = 0.0, seed=None,
                        seg: Segments = None):
    """Δ in f32 outside the kernels (as the TPU launcher does), then the
    dQ and dK/dV launches (on CUDA tensors one :class:`SegmentPlan` for
    both). -> ``(dq, dk, dv)``."""
    delta = attention_delta(out, do)
    if q.device.type == "cuda":
        seg = _plan(seg)
    extra = (dropout_p, seed, seg)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale,
                                *extra)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                                     *extra)
    return dq, dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, scale: Optional[float], dropout_p: float,
                 key: Optional[torch.Tensor], seg: Optional[torch.Tensor],
                 seg_ranges: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as the operator ``paddle_tpu_torch::flash_fwd``: ``(q,
    k, v, causal, scale, dropout_p, key or None, segment ids or None,
    their chunk ranges or None) -> (out, lse)``, ``out`` contiguous. On
    CUDA tensors it launches what :func:`flash_attention_fwd` launches
    (the TMA kernels where :func:`takes_tma` says, the first design
    otherwise; the counters advance), on CPU tensors it runs the plain
    walk. Eager calls, CUDA graph captures and programs exported with
    ``torch.export`` all reach the kernels through it: an exported
    program holds the operator, never a ``ctypes`` call, and a process
    that loads one registers it by importing this module."""
    plan = None if seg is None else SegmentPlan(seg, seg_ranges) \
        if q.device.type == "cuda" else seg
    out, lse = flash_attention_fwd(q, k, v, causal, scale, dropout_p, key,
                                   plan)
    return out.contiguous(), lse


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale, dropout_p, key, seg,
                    seg_ranges):
    B, L, H, _ = _as4(q).shape
    lse = q.new_empty((B, H, L), dtype=torch.float32)
    return q.new_empty(q.shape), _lse_shape(q, lse)


def _n_empty(q, k, causal: bool) -> int:
    """The causal rows with no allowed key: the first ``L - Lk`` when
    queries outnumber keys, else none."""
    return max(q.shape[1] - k.shape[1], 0) if causal else 0


def _empty_rows(q, k, n: int, dropout_p: float, seed) -> torch.Tensor:
    """``_sdpa_xla``'s probabilities of the ``n`` rows with no allowed key,
    ``[B, H, n, Lk]`` in the accumulation dtype: its logits there are all
    -1e30, so each key gets 1/Lk (the kept ones 1/(Lk (1 - p)) under
    dropout, with the kernels' keep mask). The kernels leave those rows
    zero; :class:`FlashAttention` adds ``P V`` to the output and ``Pᵀ dO``
    to dV (their logits are constants: dQ and dK get nothing)."""
    B, _, H, _ = _as4(q).shape
    Lk = k.shape[1]
    thresh, inv = _dropout_args(dropout_p, seed)
    p = torch.full((B, H, n, Lk), 1.0 / Lk, dtype=_acc(q), device=q.device)
    if thresh:
        rows = torch.arange(n, device=q.device)
        p = torch.where(_keep_tile(seed, B, H, rows, 0, Lk, thresh),
                        p * inv, 0.0)
    return p


class FlashAttention(torch.autograd.Function):
    """``torch.autograd.Function`` in place of the JAX ``custom_vjp``:
    forward runs the ``paddle_tpu_torch::flash_fwd`` operator
    (:func:`flash_fwd_op`) and fills the causal rows with no allowed key
    (:func:`_empty_rows`), saves ``(q, k, v, out, lse)``, the segment
    ids and the dropout key tensor, and keeps, on CUDA tensors, the ids'
    :class:`SegmentPlan` (chunk ranges and windows, built once a step,
    its ranges handed to the operator); backward runs
    :func:`flash_attention_bwd`, whose kernels regenerate the forward's
    keep mask from the same key and reuse the plan."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = False,
                scale: Optional[float] = None, dropout_p: float = 0.0,
                seed=None, seg: Optional[torch.Tensor] = None):
        plan = _plan(seg) if q.device.type == "cuda" else None
        out, lse = flash_fwd_op(q, k, v, bool(causal), scale,
                                float(dropout_p), seed, seg,
                                None if plan is None else plan.ranges)
        n = _n_empty(q, k, causal)
        if n:
            pe = _empty_rows(q, k, n, dropout_p, seed)
            _as4(out)[:, :n] = (pe @ _rows(_as4(v))).permute(0, 2, 1, 3) \
                .to(out.dtype)
        ctx.save_for_backward(q, k, v, out, lse, seg, seed)
        ctx.causal, ctx.scale = causal, scale
        ctx.dropout_p, ctx.plan = dropout_p, plan
        return out

    @staticmethod
    def backward(ctx, do):
        do = do.contiguous()
        q, k, v, out, lse, seg, key = ctx.saved_tensors
        if ctx.plan is not None:
            seg = ctx.plan
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.scale, ctx.dropout_p, key, seg)
        n = _n_empty(q, k, ctx.causal)
        if n:
            pe = _empty_rows(q, k, n, ctx.dropout_p, key)
            dof = _rows(_as4(do)[:, :n])
            dv = (_rows(_as4(dv)) + pe.transpose(-1, -2) @ dof) \
                .permute(0, 2, 1, 3).to(v.dtype).reshape(v.shape)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    seed=None):
    """Flash attention in the ``[B, L, H, D]`` layout (``scale=None`` is
    1/√D), differentiable; k and v may hold more or fewer rows than q
    (causal: row i sees the keys j <= i + Lk - L). ``dropout_p`` drops
    attention probabilities inside the kernels with the keep mask of
    ``seed``, a key tensor from ``core.random`` (``next_key(q.device)``:
    int64 ``[2]`` on the inputs' device, read by the kernels from device
    memory), regenerated in the backward from the same key; it needs a
    seed and must be below 1."""
    _dropout_args(dropout_p, seed)
    return FlashAttention.apply(q, k, v, causal, scale, float(dropout_p),
                                seed if dropout_p > 0.0 else None, None)


def flash_attention_segmented(q, k, v, seg: torch.Tensor,
                              causal: bool = False,
                              scale: Optional[float] = None):
    """``[B, L, H, D]`` + ``seg`` int ``[B, L]``: attention restricted to
    equal segment ids (varlen packing), composable with causal;
    differentiable in q, k, v."""
    return FlashAttention.apply(q, k, v, causal, scale, 0.0, None,
                                seg.to(torch.int32).contiguous())
