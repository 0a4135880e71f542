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
the launch from the operands alone: bf16 at head dim 128 without
dropout or segments, with bases and strides a TMA tensor map can
describe, goes to the TMA / ``wgmma`` kernels of
``csrc/flash_attention_tma.cu``; everything else to the first design,
``csrc/flash_attention.cuh``. Each wrapper counts every launch
(``.launches``), those of the TMA design (``.tma_launches``) and, apart,
each launch with dropout and each with segments. There is no fallback:
a CUDA call the chosen kernel refuses raises:

- :func:`flash_attention_fwd` -> ``(out, lse)``; plain version
  :func:`flash_attention_fwd_reference`, a tiled online-softmax walk;
- :func:`flash_attention_bwd_dq` -> ``dq``; plain version
  :func:`flash_attention_bwd_dq_reference`;
- :func:`flash_attention_bwd_dkv` -> ``(dk, dv)``; plain version
  :func:`flash_attention_bwd_dkv_reference`.

:func:`flash_attention_bwd_reference` is the whole plain backward
(Δ = rowsum(dO∘O) in f32, then both parts). :class:`FlashAttention` is
the ``torch.autograd.Function``: forward saves ``(q, k, v, out, lse)``
(and the segment ids and the dropout seed), backward computes Δ outside
the kernels and launches dQ and dK/dV, which regenerate the forward's
keep mask from the seed. :func:`flash_attention` and
:func:`flash_attention_segmented` are the public entries.

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

Dropout: the keep mask is a pure function of ``(seed, b, h, row, col)``
— Philox4x32-10 (:func:`philox4x32_10`) keyed by the 64-bit seed, on the
counter ``(col >> 2, row, b·H + h, 0)``, word ``col & 3``; a pair is kept
iff that word is at least ``min(floor(p·2³²), 2³²−1)``. The kernels and
the plain versions draw the same bits, whatever their tiles;
:func:`flash_dropout_keep_mask` returns the whole mask. It is not the
TPU's bit stream (``pltpu.prng_random_bits``), which no other device
reproduces.
"""
from __future__ import annotations

import ctypes
import math
import numbers
from typing import Dict, Optional, Tuple

import torch

from . import build as _build

__all__ = ["FlashAttention", "flash_attention", "flash_attention_segmented",
           "flash_attention_fwd", "flash_attention_bwd", "takes_tma",
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
_TMA_HEAD_DIM = 128                # the head dim the TMA design is built for
_INT32_MAX = 2 ** 31 - 1


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


def philox4x32_10(ctr, key: Tuple[int, int]):
    """Philox4x32-10 (the Random123 constants) on int64 tensors holding
    unsigned 32-bit words: ``ctr`` four broadcastable tensors (or ints),
    ``key`` two ints. Returns the four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
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


def _seed_words(seed: int) -> Tuple[int, int]:
    if not isinstance(seed, numbers.Integral):
        raise TypeError(f"the dropout seed is a Python int, got "
                        f"{type(seed).__name__}")
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s & _M32, s >> 32


def _keep_tile(seed: int, B: int, H: int, rows: torch.Tensor, c0: int,
               n: int, thresh: int) -> torch.Tensor:
    """Keep bits of rows ``rows`` x columns ``c0 .. c0 + n - 1``:
    ``[B, H, len(rows), n]`` bool."""
    dev = rows.device
    lo, hi = _seed_words(seed)
    g0, g1 = c0 >> 2, ((c0 + n - 1) >> 2) + 1
    grp = torch.arange(g0, g1, dtype=torch.int64, device=dev)
    bh = torch.arange(B * H, dtype=torch.int64, device=dev)
    words = philox4x32_10((grp[None, None, :], rows.long()[None, :, None],
                           bh[:, None, None], 0), (lo, hi))
    w = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    w = w.reshape(B * H, rows.numel(), -1)
    off = c0 - 4 * g0
    return (w[..., off:off + n] >= thresh).view(B, H, rows.numel(), n)


def flash_dropout_keep_mask(seed: int, B: int, H: int, L: int, p: float,
                            device=None, Lk: Optional[int] = None
                            ) -> torch.Tensor:
    """The kernels' whole keep mask, ``[B, H, L, Lk]`` bool (query row,
    key column; ``Lk`` defaults to ``L``)."""
    Lk = L if Lk is None else Lk
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
        raise ValueError("flash attention dropout needs a seed")
    _seed_words(seed)
    return dropout_threshold(dropout_p), 1.0 / (1.0 - dropout_p)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _ok(rows: torch.Tensor, cols: torch.Tensor, L: int, causal: bool,
        seg: Optional[torch.Tensor]) -> torch.Tensor:
    """Allowed pairs, broadcastable to ``[B, H, len(rows), len(cols)]``:
    columns inside L, at or before the row when causal, in the row's
    segment."""
    ok = (cols < L)[None, :].expand(rows.numel(), -1)
    if causal:
        ok = ok & (cols[None, :] <= rows[:, None])
    ok = ok[None, None]
    if seg is not None:
        sc = seg[:, cols.clamp(max=L - 1)]
        ok = ok & (seg[:, rows, None] == sc[:, None, :])[:, None]
    return ok


def _check_seg(seg: Optional[torch.Tensor], B: int, L: int, device):
    if seg is None:
        return
    if seg.dtype != torch.int32 or tuple(seg.shape) != (B, L) \
            or seg.device != device:
        raise ValueError(f"seg must be int32 [B, L] = [{B}, {L}] on "
                         f"{device}, got {seg.dtype} {tuple(seg.shape)} "
                         f"on {seg.device}")


def flash_attention_fwd_reference(q, k, v, causal: bool = False,
                                  scale: Optional[float] = None,
                                  dropout_p: float = 0.0,
                                  seed: Optional[int] = None,
                                  seg: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: an online-softmax walk over KV tiles of the
    kernel's width with the kernel's roundings and keep mask. Returns
    ``(out, lse)``."""
    q4, k4, v4 = _as4(q), _as4(k), _as4(v)
    B, L, H, D = q4.shape
    _check_seg(seg, B, L, q.device)
    thresh, inv = _dropout_args(dropout_p, seed)
    s = _scale(D, scale)
    qf = _rows(q4)
    acc_t = qf.dtype
    rows = torch.arange(L, device=q.device)
    m = torch.full((B, H, L), _NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros((B, H, L), dtype=acc_t, device=q.device)
    acc = torch.zeros((B, H, L, D), dtype=acc_t, device=q.device)
    for k0 in range(0, L, _BLOCK):
        kb = _rows(k4[:, k0:k0 + _BLOCK])
        vb = _rows(v4[:, k0:k0 + _BLOCK])
        cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        ok = _ok(rows, cols, L, causal, seg)
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
    and dS = P∘(keep∘dO Vᵀ/(1−p) − Δ)·scale, f32 ``[B, H, L, 64]`` — the
    algebra of the TPU backward kernels."""
    q4, k4, v4, do4 = _as4(q), _as4(k), _as4(v), _as4(do)
    B, L, H, D = q4.shape
    _check_seg(seg, B, L, q.device)
    thresh, inv = _dropout_args(dropout_p, seed)
    s = _scale(D, scale)
    qf, dof = _rows(q4), _rows(do4)
    lse4 = _lse4(q, lse).to(qf.dtype)[..., None]
    dl4 = _lse4(q, delta).to(qf.dtype)[..., None]
    rows = torch.arange(L, device=q.device)
    for k0 in range(0, L, _BLOCK):
        kb = _rows(k4[:, k0:k0 + _BLOCK])
        vb = _rows(v4[:, k0:k0 + _BLOCK])
        cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        ok = _ok(rows, cols, L, causal, seg)
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
                                     seed: Optional[int] = None,
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
                                      seed: Optional[int] = None,
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
                                  seed: Optional[int] = None,
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
        tail = [p, i, i, i, i, i, ctypes.c_float, i,
                p, ctypes.c_longlong, p, u, u, u, ctypes.c_float, p]
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
    (bf16, head dim 128)."""
    global _tma_lib
    if _tma_lib is None:
        lib = _build.load("flash_attention_tma")
        p, i = ctypes.c_void_p, ctypes.c_int
        tail = [p, i, i, i, i, i, ctypes.c_float, p]
        lib.flash_attention_tma_forward.argtypes = [p] * 5 + tail
        lib.flash_attention_tma_backward_dq.argtypes = [p] * 7 + tail
        lib.flash_attention_tma_backward_dkv.argtypes = [p] * 8 + tail
        for fn in (lib.flash_attention_tma_forward,
                   lib.flash_attention_tma_backward_dq,
                   lib.flash_attention_tma_backward_dkv):
            fn.restype = ctypes.c_int
        _tma_lib = lib
    return _tma_lib


def takes_tma(q, k, v, do=None, *, dropout_p: float = 0.0,
              seg=None) -> bool:
    """Whether the TMA / ``wgmma`` kernels take a call, from the operands'
    dtype, shapes, alignment and strides alone (nothing is launched).

    They take ``q``, ``k``, ``v`` (and the backward's ``do``) in bf16 of
    one shape, ``[B, L, H, D]`` or ``[BH, L, D]``, with head dim 128
    contiguous, no dropout and no segments; every base 16-byte aligned
    and every (batch, seq, head) stride a multiple of 8 elements (16
    bytes), so that a TMA tensor map describes each tensor in place (q,
    k, v may be strided views of one projection); and sizes inside the
    grid's and the kernels' 32-bit ranges."""
    if dropout_p > 0.0 or seg is not None:
        return False
    ts = [t for t in (q, k, v, do) if t is not None]
    if any(t.dtype != torch.bfloat16 or t.shape != q.shape for t in ts):
        return False
    if q.dim() not in (3, 4) or q.shape[-1] != _TMA_HEAD_DIM \
            or q.numel() == 0:
        return False
    B, L, H, _ = _as4(q).shape
    if B > 65535 or H > 65535 or B * H * L > _INT32_MAX:
        return False
    return all(_as4(t).stride(3) == 1 and t.data_ptr() % 16 == 0
               and all(x % 8 == 0 for x in _as4(t).stride()[:3])
               for t in ts)


def _check(name: str, q, tensors, f32s=(), seg=None
           ) -> Tuple[int, int, int, int]:
    """Device, dtype, shape, stride and alignment checks of a launch;
    returns ``(B, L, H, D)``."""
    def need(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")

    need(q.dtype in _DTYPE_CODES,
         f"dtype {q.dtype} (float32 or bfloat16)")
    q4 = _as4(q)
    B, L, H, D = q4.shape
    need(D in _HEAD_DIMS, f"head dim {D} not in {_HEAD_DIMS}")
    vec = 16 // q.element_size()
    for t in tensors:
        need(t.dtype == q.dtype, f"dtypes differ: {t.dtype} vs {q.dtype}")
        need(t.shape == q.shape, f"shapes differ: {tuple(t.shape)} vs "
                                 f"{tuple(q.shape)}")
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
    return B, L, H, D


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


def _launch(wrapper, fn, name, args, shape, causal, scale, dtype, device,
            dropout_p, seed, seg):
    B, L, H, D = shape
    thresh, inv = _dropout_args(dropout_p, seed)
    lo, hi = _seed_words(seed) if thresh else (0, 0)
    rng = _seg_ranges(seg) if seg is not None else None
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, B, L, H, D, int(bool(causal)), scale,
            _DTYPE_CODES[dtype],
            seg.data_ptr() if seg is not None else None,
            seg.stride(0) if seg is not None else 0,
            rng.data_ptr() if rng is not None else None,
            lo, hi, thresh, inv, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError "
                           f"{rc} (B={B} L={L} H={H} D={D} {dtype} "
                           f"causal={bool(causal)} dropout_p={dropout_p} "
                           f"segments={seg is not None})")
    wrapper.launches += 1
    wrapper.dropout_launches += bool(thresh)
    wrapper.segmented_launches += seg is not None


def _launch_tma(wrapper, fn, name, args, shape, causal, scale, device):
    """A launch of the TMA design (``takes_tma`` accepted the call): the
    C entry re-checks and returns an error, which raises here."""
    B, L, H, D = shape
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, B, L, H, D, int(bool(causal)), scale, stream)
    if rc != 0:
        what = "cuTensorMapEncodeTiled refused a tensor map" if rc == -1 \
            else f"kernel launch failed with cudaError {rc}"
        raise RuntimeError(f"{name}: TMA {what} (B={B} L={L} H={H} D={D} "
                           f"causal={bool(causal)})")
    wrapper.launches += 1
    wrapper.tma_launches += 1


def _on(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU tensor (plain)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        dropout_p: float = 0.0, seed: Optional[int] = None,
                        seg: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors (the plain walk for CPU
    tensors). -> ``(out, lse)``."""
    name = "flash_attention_fwd"
    if not _on(q, name):
        return flash_attention_fwd_reference(q, k, v, causal, scale,
                                             dropout_p, seed, seg)
    shape = _check(name, q, (q, k, v), seg=seg)
    s = _scale(shape[3], scale)
    out = torch.empty_like(q)
    lse = torch.empty((shape[0], shape[2], shape[1]), dtype=torch.float32,
                      device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _strides(q, k, v, out))
    if takes_tma(q, k, v, dropout_p=dropout_p, seg=seg):
        _launch_tma(flash_attention_fwd,
                    _kernel_lib_tma().flash_attention_tma_forward, name,
                    args, shape, causal, s, q.device)
    else:
        _launch(flash_attention_fwd,
                _kernel_lib(q.dtype, shape[3]).flash_attention_forward, name,
                args, shape, causal, s, q.dtype, q.device, dropout_p, seed,
                seg)
    return out, _lse_shape(q, lse)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                           scale: Optional[float] = None,
                           dropout_p: float = 0.0,
                           seed: Optional[int] = None,
                           seg: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Launch the dQ kernel on CUDA tensors (its plain version for CPU
    tensors)."""
    name = "flash_attention_bwd_dq"
    if not _on(q, name):
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal, scale, dropout_p,
                                                seed, seg)
    shape = _check(name, q, (q, k, v, do), (lse, delta), seg=seg)
    s = _scale(shape[3], scale)
    dq = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, do, dq))
    if takes_tma(q, k, v, do, dropout_p=dropout_p, seg=seg):
        _launch_tma(flash_attention_bwd_dq,
                    _kernel_lib_tma().flash_attention_tma_backward_dq, name,
                    args, shape, causal, s, q.device)
    else:
        _launch(flash_attention_bwd_dq,
                _kernel_lib(q.dtype, shape[3]).flash_attention_backward_dq,
                name, args, shape, causal, s, q.dtype, q.device, dropout_p,
                seed, seg)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                            scale: Optional[float] = None,
                            dropout_p: float = 0.0,
                            seed: Optional[int] = None,
                            seg: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel on CUDA tensors (its plain version for
    CPU tensors). -> ``(dk, dv)``."""
    name = "flash_attention_bwd_dkv"
    if not _on(q, name):
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, scale, dropout_p,
                                                 seed, seg)
    shape = _check(name, q, (q, k, v, do), (lse, delta), seg=seg)
    s = _scale(shape[3], scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, do, dk, dv))
    if takes_tma(q, k, v, do, dropout_p=dropout_p, seg=seg):
        _launch_tma(flash_attention_bwd_dkv,
                    _kernel_lib_tma().flash_attention_tma_backward_dkv, name,
                    args, shape, causal, s, q.device)
    else:
        _launch(flash_attention_bwd_dkv,
                _kernel_lib(q.dtype, shape[3]).flash_attention_backward_dkv,
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
                        dropout_p: float = 0.0, seed: Optional[int] = None,
                        seg: Optional[torch.Tensor] = None):
    """Δ in f32 outside the kernels (as the TPU launcher does), then the
    dQ and dK/dV launches. -> ``(dq, dk, dv)``."""
    delta = attention_delta(out, do)
    extra = (dropout_p, seed, seg)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale,
                                *extra)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                                     *extra)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``torch.autograd.Function`` in place of the JAX ``custom_vjp``:
    forward saves ``(q, k, v, out, lse)`` and the segment ids, and keeps
    the dropout seed; backward runs :func:`flash_attention_bwd`, whose
    kernels regenerate the forward's keep mask from that seed."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = False,
                scale: Optional[float] = None, dropout_p: float = 0.0,
                seed: Optional[int] = None,
                seg: Optional[torch.Tensor] = None):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, dropout_p,
                                       seed, seg)
        ctx.save_for_backward(q, k, v, out, lse, seg)
        ctx.causal, ctx.scale = causal, scale
        ctx.dropout_p, ctx.seed = dropout_p, seed
        return out

    @staticmethod
    def backward(ctx, do):
        do = do.contiguous()
        q, k, v, out, lse, seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.scale, ctx.dropout_p, ctx.seed,
                                         seg)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    seed: Optional[int] = None):
    """Flash attention in the ``[B, L, H, D]`` layout (``scale=None`` is
    1/√D), differentiable. ``dropout_p`` drops attention probabilities
    inside the kernels with the keep mask of ``seed`` (a 64-bit int, e.g.
    ``core.random.kernel_seed()``), regenerated in the backward; it needs
    a seed and must be below 1."""
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
