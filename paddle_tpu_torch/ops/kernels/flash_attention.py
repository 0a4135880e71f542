"""Flash attention: the Hopper kernels, their plain versions, autograd.

Replaces the TPU kernels of ``paddle_tpu/ops/pallas/flash_attention.py``
(``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) and the
``custom_vjp`` around them. Tensors are ``[B, L, H, D]`` (the paddle
flash-attention layout) or ``[BH, L, D]`` (the TPU's transposed layout,
taken as ``H = 1``); ``lse`` and ``delta`` are f32 ``[B, H, L]``
(``[BH, L]`` for 3-D inputs).

Three wrappers launch the CUDA kernels of ``csrc/flash_attention.cu`` on
CUDA tensors and count each launch; a CPU tensor takes the plain version
of the same function (and counts nothing); there is no fallback — a CUDA
call the kernel cannot take raises:

- :func:`flash_attention_fwd` -> ``(out, lse)``; plain version
  :func:`flash_attention_fwd_reference`, a tiled online-softmax walk;
- :func:`flash_attention_bwd_dq` -> ``dq``; plain version
  :func:`flash_attention_bwd_dq_reference`;
- :func:`flash_attention_bwd_dkv` -> ``(dk, dv)``; plain version
  :func:`flash_attention_bwd_dkv_reference`.

:func:`flash_attention_bwd_reference` is the whole plain backward
(Δ = rowsum(dO∘O) in f32, then both parts). :class:`FlashAttention` is
the ``torch.autograd.Function``: forward saves ``(q, k, v, out, lse)``,
backward computes Δ outside the kernels and launches dQ and dK/dV.
:func:`flash_attention` is the public entry.

Numerics (the TPU kernels'): every product accumulates in f32 over
operands in the input dtype (the plain versions multiply f32 copies of
those operands, which is the same arithmetic up to summation order);
P is rounded to V's dtype before PV, dS to K's / Q's dtype before its
products; softmax statistics are f32; a masked logit is -1e30 and masked
probabilities are exactly zero; ``out = acc / max(l, 1e-30)`` and
``lse = m + log(max(l, 1e-30))``. Any ``L >= 1`` is taken: the ragged
tail is masked (the JAX entry instead falls back to XLA for shapes that
do not tile).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build as _build

__all__ = ["FlashAttention", "flash_attention", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_fwd_reference",
           "flash_attention_bwd_reference",
           "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference", "attention_delta"]

_NEG_INF = -1e30
_BLOCK = 64                        # the plain walk's KV tile (the kernels')
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_lib = None


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


def _causal_ok(rows: torch.Tensor, cols: torch.Tensor, L: int,
               causal: bool) -> torch.Tensor:
    ok = (cols < L)[None, :].expand(rows.numel(), -1)
    if causal:
        ok = ok & (cols[None, :] <= rows[:, None])
    return ok


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def flash_attention_fwd_reference(q, k, v, causal: bool = False,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: an online-softmax walk over KV tiles of the
    kernel's width with the kernel's roundings. Returns ``(out, lse)``."""
    q4, k4, v4 = _as4(q), _as4(k), _as4(v)
    B, L, H, D = q4.shape
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
        ok = _causal_ok(rows, cols, L, causal)
        logits = torch.where(ok, (qf @ kb.transpose(-1, -2)) * s, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # re-masked: a row whose columns are all masked so far has
        # logits == m_new == -1e30 and exp() == 1
        p = torch.where(ok, torch.exp(logits - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + p.to(v.dtype).to(acc_t) @ vb
        m = m_new
    lm = l.clamp(min=1e-30)
    out = (acc / lm[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    lse = m + torch.log(lm)
    return out.reshape(q.shape).contiguous(), _lse_shape(q, lse)


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO∘O) in f32, ``[B, H, L]`` (``[BH, L]`` for 3-D)."""
    acc_t = _acc(out)
    d = (do.to(acc_t) * out.to(acc_t)).sum(dim=-1)     # [B, L, H]/[BH, L]
    return d.transpose(1, 2).contiguous() if out.dim() == 4 else d


def _bwd_tiles(q, k, v, do, lse, delta, causal, scale):
    """Yield, per KV tile, ``(kb, p, ds)`` with
    P = exp(scale·QKᵀ − lse) (masked) and dS = P∘(dO Vᵀ − Δ)·scale, f32
    ``[B, H, L, 64]`` — the algebra of the TPU backward kernels."""
    q4, k4, v4, do4 = _as4(q), _as4(k), _as4(v), _as4(do)
    B, L, H, D = q4.shape
    s = _scale(D, scale)
    qf, dof = _rows(q4), _rows(do4)
    lse4 = _lse4(q, lse).to(qf.dtype)[..., None]
    dl4 = _lse4(q, delta).to(qf.dtype)[..., None]
    rows = torch.arange(L, device=q.device)
    for k0 in range(0, L, _BLOCK):
        kb = _rows(k4[:, k0:k0 + _BLOCK])
        vb = _rows(v4[:, k0:k0 + _BLOCK])
        cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        ok = _causal_ok(rows, cols, L, causal)
        p = torch.where(ok, torch.exp(s * (qf @ kb.transpose(-1, -2))
                                      - lse4), 0.0)
        dp = dof @ vb.transpose(-1, -2)
        ds = p * (dp - dl4) * s
        yield kb, p, ds


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                     causal: bool = False,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """The dQ kernel's function in plain PyTorch: dQ = Σ_tiles dS K with
    dS rounded to K's dtype."""
    dq = None
    for kb, _, ds in _bwd_tiles(q, k, v, do, lse, delta, causal, scale):
        part = ds.to(k.dtype).to(kb.dtype) @ kb
        dq = part if dq is None else dq + part
    return dq.permute(0, 2, 1, 3).to(q.dtype).reshape(q.shape).contiguous()


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                      causal: bool = False,
                                      scale: Optional[float] = None
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's function in plain PyTorch: per KV tile,
    dV = Pᵀ dO and dK = dSᵀ Q (P, dS rounded to dO's / Q's dtype)."""
    qf, dof = _rows(_as4(q)), _rows(_as4(do))
    dks, dvs = [], []
    for _, p, ds in _bwd_tiles(q, k, v, do, lse, delta, causal, scale):
        dvs.append(p.to(do.dtype).to(dof.dtype).transpose(-1, -2) @ dof)
        dks.append(ds.to(q.dtype).to(qf.dtype).transpose(-1, -2) @ qf)
    dk = torch.cat(dks, dim=2).permute(0, 2, 1, 3).to(k.dtype)
    dv = torch.cat(dvs, dim=2).permute(0, 2, 1, 3).to(v.dtype)
    return dk.reshape(k.shape).contiguous(), dv.reshape(v.shape).contiguous()


def flash_attention_bwd_reference(q, k, v, out, lse, do,
                                  causal: bool = False,
                                  scale: Optional[float] = None):
    """The whole plain backward: Δ, then dQ and dK/dV. -> (dq, dk, dv)."""
    delta = attention_delta(out, do)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                          scale)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               causal, scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        tail = [p, i, i, i, i, i, ctypes.c_float, i, p]
        lib.flash_attention_forward.argtypes = [p] * 5 + tail
        lib.flash_attention_backward_dq.argtypes = [p] * 7 + tail
        lib.flash_attention_backward_dkv.argtypes = [p] * 8 + tail
        for fn in (lib.flash_attention_forward,
                   lib.flash_attention_backward_dq,
                   lib.flash_attention_backward_dkv):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, q, tensors, f32s=()) -> Tuple[int, int, int, int]:
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
    return B, L, H, D


def _strides(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in _as4(t).stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(fn, name, args, shape, causal, scale, dtype, device):
    B, L, H, D = shape
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, B, L, H, D, int(bool(causal)), scale,
            _DTYPE_CODES[dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError "
                           f"{rc} (B={B} L={L} H={H} D={D} {dtype} "
                           f"causal={bool(causal)})")


def _on(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU tensor (plain)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors (the plain walk for CPU
    tensors). -> ``(out, lse)``."""
    name = "flash_attention_fwd"
    if not _on(q, name):
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    shape = _check(name, q, (q, k, v))
    s = _scale(shape[3], scale)
    out = torch.empty_like(q)
    lse = torch.empty((shape[0], shape[2], shape[1]), dtype=torch.float32,
                      device=q.device)
    lib = _kernel_lib()
    _launch(lib.flash_attention_forward, name,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), _strides(q, k, v, out)),
            shape, causal, s, q.dtype, q.device)
    flash_attention_fwd.launches += 1
    return out, _lse_shape(q, lse)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Launch the dQ kernel on CUDA tensors (its plain version for CPU
    tensors)."""
    name = "flash_attention_bwd_dq"
    if not _on(q, name):
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal, scale)
    shape = _check(name, q, (q, k, v, do), (lse, delta))
    s = _scale(shape[3], scale)
    dq = torch.empty_like(q)
    lib = _kernel_lib()
    _launch(lib.flash_attention_backward_dq, name,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             _strides(q, k, v, do, dq)),
            shape, causal, s, q.dtype, q.device)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel on CUDA tensors (its plain version for
    CPU tensors). -> ``(dk, dv)``."""
    name = "flash_attention_bwd_dkv"
    if not _on(q, name):
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, scale)
    shape = _check(name, q, (q, k, v, do), (lse, delta))
    s = _scale(shape[3], scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _kernel_lib()
    _launch(lib.flash_attention_backward_dkv, name,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _strides(q, k, v, do, dk, dv)),
            shape, causal, s, q.dtype, q.device)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False,
                        scale: Optional[float] = None):
    """Δ in f32 outside the kernels (as the TPU launcher does), then the
    dQ and dK/dV launches. -> ``(dq, dk, dv)``."""
    delta = attention_delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``torch.autograd.Function`` in place of the JAX ``custom_vjp``:
    forward saves ``(q, k, v, out, lse)``; backward runs
    :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = False,
                scale: Optional[float] = None):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        do = do.contiguous()
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, dropout_p: float = 0.0):
    """Flash attention in the ``[B, L, H, D]`` layout (``scale=None`` is
    1/√D), differentiable. ``dropout_p > 0`` is kernel K5 of the port's
    roadmap (the dropout mask inside the kernels), not ported yet."""
    if dropout_p > 0.0:
        raise NotImplementedError(
            "flash attention dropout (kernel K5, the in-kernel keep mask) "
            "is not ported yet; call with dropout_p=0")
    return FlashAttention.apply(q, k, v, causal, scale)
