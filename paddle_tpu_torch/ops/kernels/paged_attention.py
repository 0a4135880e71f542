"""Block-table paged attention: the Hopper kernel and its plain walk.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/paged_attention.py``
(``_kernel`` via ``_paged_attention_call``). Two functions share one
flat signature ``(q, k_pool, v_pool, tables, positions)``:

- :func:`paged_attention_reference` — the plain PyTorch walk, a port of
  the JAX package's jnp walk (``serving_cache.paged_attention`` with
  ``use_kernel=False``): an online-softmax loop over ``block_size``
  tiles that gathers one block per slot per tile. It is the kernel's
  oracle, and the path every CPU tensor takes.
- :func:`paged_attention_kernel` — the wrapper of the CUDA kernel in
  ``csrc/paged_attention.cu``. For a CUDA tensor it checks device,
  dtype, shape and contiguity, allocates the output, launches on the
  current stream and raises on a non-zero return code; it counts each
  launch in ``paged_attention_kernel.launches``. There is no fallback:
  a CUDA call the kernel cannot take raises. A CPU tensor takes the
  plain walk (and counts nothing).

Contract: row ``(s, t)`` attends every column ``c <= positions[s, t]``
of its slot's history; query head ``h = kvh * n_rep + r`` attends the
unexpanded KV head ``kvh``; ``k_scale``/``v_scale`` (int8 pools) switch
the tile load to dequantization; every gathered tile goes through
``nan_to_num`` and masked columns contribute exactly zero; tiles at or
past ``n_tiles`` are skipped.

Numerics. The walk follows the JAX walk's roundings: dequantized tiles
are cast to q's dtype, and the probabilities are cast to V's dtype
before the PV product (both dots accumulate in f32). The kernel keeps
everything in f32 from the load to the output cast, as the TPU kernel
does. In f32 the two differ only by summation order; in bf16 they
differ by those bf16 roundings.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from . import build as _build

__all__ = ["paged_attention_reference", "paged_attention_kernel"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)
_lib = None


def paged_attention_reference(q, k_pool, v_pool, tables, positions, *,
                              block_size: int, n_rep: int,
                              n_tiles: Union[int, torch.Tensor, None] = None,
                              k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain tiled walk (see the module docstring). ``q [S, T, H, D]``,
    pools ``[num_blocks, block_size, KVH, D]``, ``tables [S, MB]``
    (entry < 0 = unmapped), ``positions [S, T]``."""
    S, T, H, D = q.shape
    K = k_pool.shape[2]
    R = int(n_rep)
    if K * R != H:
        raise ValueError(f"KV heads {K} x n_rep {R} != query heads {H}")
    MB = tables.shape[1]
    n_walk = MB if n_tiles is None else min(int(n_tiles), MB)
    dev = q.device
    q5 = q.reshape(S, T, K, R, D).float()
    inv_sqrt_d = 1.0 / math.sqrt(D)
    cols0 = torch.arange(block_size, device=dev)
    pos = positions.to(dev)
    tables = tables.to(dev).long()
    m = torch.full((S, K, R, T), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((S, K, R, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((S, K, R, T, D), dtype=torch.float32, device=dev)
    for i in range(n_walk):
        phys = tables[:, i].clamp(min=0)               # [S]
        k_t = k_pool[phys]                             # [S, bs, K, D]
        v_t = v_pool[phys]
        if k_scale is not None:
            k_t = (k_t.float() * k_scale[phys][..., None]).to(q.dtype)
            v_t = (v_t.float() * v_scale[phys][..., None]).to(q.dtype)
        # recycled blocks may hold NaN/inf from an earlier request:
        # masked columns must contribute EXACTLY zero, and 0 * NaN is
        # NaN in the PV product — sanitize every gathered tile
        k_t = torch.nan_to_num(k_t)
        v_t = torch.nan_to_num(v_t)
        s = torch.einsum("stkrd,sbkd->skrtb", q5, k_t.float()) * inv_sqrt_d
        ok = (i * block_size + cols0)[None, None, :] <= pos[:, :, None]
        okb = ok[:, None, None, :, :]                  # [S, 1, 1, T, bs]
        s = torch.where(okb, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a fully masked row has s == m_new == -1e30 and exp() gives 1:
        # re-mask p so its contribution is exactly zero
        p = torch.where(okb, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("skrtb,sbkd->skrtd", p.to(v_t.dtype).float(),
                          v_t.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(S, T, H, D).to(q.dtype)


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        fn = lib.paged_attention_forward
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k_pool, v_pool, tables, positions, k_scale, v_scale,
           block_size: int, n_rep: int) -> None:
    def need(cond, msg):
        if not cond:
            raise ValueError(f"paged_attention_kernel: {msg}")

    dev = q.device
    need(q.dim() == 4, f"q must be [S, T, H, D], got {tuple(q.shape)}")
    S, T, H, D = q.shape
    need(q.dtype in (torch.float32, torch.bfloat16),
         f"q dtype {q.dtype} (float32 or bfloat16)")
    need(D in _HEAD_DIMS, f"head dim {D} not in {_HEAD_DIMS}")
    need(k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
         f"pools must share one [NB, bs, KVH, D] shape, got "
         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    NB, bs, K, Dk = k_pool.shape
    need(bs == block_size and Dk == D,
         f"pool [*, {bs}, *, {Dk}] vs block_size {block_size}, D {D}")
    need(K * n_rep == H, f"KV heads {K} x n_rep {n_rep} != heads {H}")
    need(k_pool.dtype == v_pool.dtype and k_pool.dtype in _DTYPE_CODES,
         f"pool dtypes {k_pool.dtype}/{v_pool.dtype}")
    quant = k_pool.dtype == torch.int8
    need(quant == (k_scale is not None) == (v_scale is not None),
         "int8 pools need k_scale and v_scale, other pools neither")
    if quant:
        for sc in (k_scale, v_scale):
            need(sc.dtype == torch.float32
                 and tuple(sc.shape) == (NB, bs, K),
                 f"scales must be float32 [{NB}, {bs}, {K}], got "
                 f"{sc.dtype} {tuple(sc.shape)}")
    need(tables.dtype == torch.int32 and tables.dim() == 2
         and tables.shape[0] == S,
         f"tables must be int32 [{S}, MB], got {tables.dtype} "
         f"{tuple(tables.shape)}")
    need(positions.dtype == torch.int32
         and tuple(positions.shape) == (S, T),
         f"positions must be int32 [{S}, {T}], got {positions.dtype} "
         f"{tuple(positions.shape)}")
    ts = [q, k_pool, v_pool, tables, positions]
    if quant:
        ts += [k_scale, v_scale]
    need(all(t.device == dev for t in ts), "all tensors on one device")
    need(all(t.is_contiguous() for t in ts), "all tensors contiguous")


def paged_attention_kernel(q, k_pool, v_pool, tables, positions, *,
                           block_size: int, n_rep: int,
                           n_tiles: Union[int, torch.Tensor, None] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Launch the Hopper paged-attention kernel on CUDA tensors (the
    plain walk for CPU tensors). ``n_tiles`` may be an int or a device
    int32 tensor of one element (what the engines pass, so a captured
    step keeps its pointer); ``None`` walks every table column."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, tables, positions, block_size=block_size,
            n_rep=n_rep, n_tiles=n_tiles, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_kernel runs on cuda or cpu "
                         f"tensors, got {q.device}")
    block_size, n_rep = int(block_size), int(n_rep)
    _check(q, k_pool, v_pool, tables, positions, k_scale, v_scale,
           block_size, n_rep)
    S, T, H, D = q.shape
    NB, _, K, _ = k_pool.shape
    MB = tables.shape[1]
    if not isinstance(n_tiles, torch.Tensor):
        n_tiles = torch.tensor([MB if n_tiles is None else int(n_tiles)],
                               dtype=torch.int32, device=q.device)
    if n_tiles.dtype != torch.int32 or n_tiles.numel() != 1 \
            or n_tiles.device != q.device:
        raise ValueError("paged_attention_kernel: n_tiles must be a "
                         "one-element int32 tensor on q's device")
    out = torch.empty_like(q)
    quant = k_scale is not None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel_lib().paged_attention_forward(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        tables.data_ptr(), positions.data_ptr(), n_tiles.data_ptr(),
        out.data_ptr(), S, T, H, K, D, block_size, MB, NB,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed with cudaError {rc} "
            f"(S={S} T={T} H={H} KVH={K} D={D} bs={block_size} "
            f"q={q.dtype} pools={k_pool.dtype})")
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
