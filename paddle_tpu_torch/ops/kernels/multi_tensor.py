"""The fused optimizer step's multi-tensor kernels and their plain versions.

The JAX package runs its whole optimizer step as one XLA program
(``paddle_tpu/optimizer/fused_step.py``): gradient unscale and finite
check, clipping, every Adam/AdamW update and the skip of a non-finite
step. It has no Pallas kernel there. In the port the same step runs as
two hand-written Hopper kernels (``csrc/multi_tensor_optimizer.cu``),
each over a table of tensors:

- :func:`multi_tensor_unscale_norm` (O1): with ``inv_scale`` it unscales
  every gradient in place, ``(g.f32 * inv_scale)`` rounded to the
  gradient's dtype, and checks it for non-finite values; it computes
  every gradient's f32 sum of squares and the global norm, and the clip
  scale of a ``("global_norm", cn)`` or ``("norm", cn)`` clip spec
  (``utils/clip_grad.py``). Results stay in device memory.
- :func:`multi_tensor_adam` (O2): Adam (L2 decay folded into the
  gradient) or AdamW (decoupled decay) on every parameter in place —
  the clip (O1's scale or a value clamp) first, then moments, bias
  corrections and parameter, and the beta powers — reading ``lr``, the
  scale and up to two found flags (OR'd; a set flag skips every write)
  from device memory.

On CUDA tensors each wrapper launches its kernel (one launch for up to
256 tensors, more for more, plus O1's one-block finalize) and adds each
launch to its ``.launches``; on CPU tensors it runs its plain version
(:func:`multi_tensor_unscale_norm_reference`,
:func:`multi_tensor_adam_reference`), which counts nothing. The kernels
take f32, bf16 and f16, each tensor in its own; a tensor that is not
contiguous goes through a contiguous copy. There is no fallback: a CUDA
call the kernels cannot take (another dtype or device), a failed build
or a failed launch raises. :class:`AdamTable` lays a parameter list out
once, so a caller stepping the same parameters (``fused_step``) checks
only the gradients each step.

Numerics: the plain versions are plain PyTorch per tensor with the
per-parameter loop's operations in its order (``optimizer/optimizer.py``
``Adam._update``, ``utils/clip_grad.py``), and the kernels do each of
those operations as one correctly rounded f32 operation, so parameters,
moments and powers come out bit-equal to the plain versions given the
same clip scale, and the plain versions bit-equal to the loop on the
CPU. O1's sums of squares add in another order on the card (chunks of
32768 elements, then the chunks by a fixed tree, then the tensors in
order; the same on every run).
"""
from __future__ import annotations

import ctypes
from collections import namedtuple
from typing import Optional, Sequence

import numpy as np
import torch

from ...utils.clip_grad import (clamp_grad, global_scale, scale_grad,
                                sum_of_squares, tensor_scale)
from . import build as _build

__all__ = ["AdamTable", "UnscaleNorm", "multi_tensor_unscale_norm",
           "multi_tensor_unscale_norm_reference", "multi_tensor_adam",
           "multi_tensor_adam_reference", "config"]

UnscaleNorm = namedtuple("UnscaleNorm", "found scale stats")
UnscaleNorm.__doc__ = """O1's results, in device memory: ``found`` the
0-d bool non-finite flag (None without ``inv_scale``), ``scale`` the f32
clip scale (``[1]`` for a global norm, ``[n]`` per tensor, None without
a norm clip), ``stats`` f32 ``[n + 1]``: each gradient's sum of squares,
then the global norm."""

_KINDS = {(): 0, "global_norm": 1, "norm": 2, "value": 3}
# a table row's code (csrc/multi_tensor_optimizer.cu Code): the
# parameter's, gradient's and moments' dtypes, two bits each, and the decay
_DT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_G_SHIFT, _M_SHIFT, _USE_WD = 2, 4, 64
_COLS = 8
_lib = None


def _clip_kind(clip) -> int:
    if clip is None or clip == ():
        return 0
    if clip[0] not in _KINDS:
        raise ValueError(f"unknown clip spec {clip!r}")
    return _KINDS[clip[0]]


def _found_mask(found):
    """The OR of the given 0-d bool flags, or None."""
    flags = [f for f in (found or ()) if f is not None]
    if not flags:
        return None
    out = flags[0]
    for f in flags[1:]:
        out = torch.logical_or(out, f)
    return out


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

@torch.no_grad()
def multi_tensor_unscale_norm_reference(grads: Sequence[torch.Tensor],
                                        inv_scale: Optional[torch.Tensor]
                                        = None, clip=()) -> UnscaleNorm:
    """O1's function in plain PyTorch (the JAX package's ``_unscale_fn``
    and ``clip_by_spec`` norms)."""
    found = None
    if inv_scale is not None:
        for g in grads:
            g.copy_(scale_grad(g, inv_scale))
        found = torch.logical_not(torch.stack(
            [torch.all(torch.isfinite(g)) for g in grads]).all())
    sq = [sum_of_squares(g) for g in grads]
    gnorm = torch.sqrt(sum(sq))
    stats = torch.stack(sq + [gnorm])
    scale = None
    kind = _clip_kind(clip)
    if kind == 1:
        scale = global_scale(gnorm, clip[1]).reshape(1)
    elif kind == 2:
        scale = torch.stack([tensor_scale(s, clip[1]) for s in sq])
    return UnscaleNorm(found, scale, stats)


@torch.no_grad()
def multi_tensor_adam_reference(params, grads, moment1, moment2, beta1_pow,
                                beta2_pow, weight_decays, *, lr, beta1,
                                beta2, epsilon, decoupled, clip=(),
                                scale=None, found=()) -> None:
    """O2's function in plain PyTorch, in place: per tensor the clip
    (``scale[0]`` / ``scale[i]`` from O1, or the value clamp), then the
    loop's Adam update, each result masked by the OR of ``found``."""
    kind = _clip_kind(clip)
    mask = _found_mask(found)
    b1, b2, eps = beta1, beta2, epsilon
    for i, (p, g, m1, m2, b1p, b2p, wd) in enumerate(zip(
            params, grads, moment1, moment2, beta1_pow, beta2_pow,
            weight_decays)):
        if kind == 3:
            g = clamp_grad(g, clip[1], clip[2])
        elif kind:
            g = scale_grad(g, scale[0] if kind == 1 else scale[i])
        g = g.float()
        p32 = p.float()
        if wd and not decoupled:
            g = g + wd * p32
        nm1 = b1 * m1.float() + (1 - b1) * g
        nm2 = b2 * m2.float() + (1 - b2) * g * g
        nb1p = b1p * b1
        nb2p = b2p * b2
        upd = (nm1 / (1 - nb1p)) / (torch.sqrt(nm2 / (1 - nb2p)) + eps)
        if wd and decoupled:
            upd = upd + wd * p32
        new = ((p32 - lr * upd).to(p.dtype), nm1.to(m1.dtype),
               nm2.to(m2.dtype), nb1p, nb2p)
        for old, val in zip((p, m1, m2, b1p, b2p), new):
            if mask is not None:
                val = torch.where(mask, old, val)
            old.copy_(val)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("multi_tensor_optimizer")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mt_config.argtypes = [p, p]
        lib.mt_config.restype = None
        lib.mt_unscale_norm.argtypes = [p, i, p, p, p, p, p, p, i, f, p, p,
                                        p, p]
        lib.mt_adam.argtypes = [p, p, i, p, p, i, f, f, p, p, f, f, f, f, f,
                                i, p, p, p]
        for fn in (lib.mt_unscale_norm, lib.mt_adam):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def config():
    """``(chunk, max_tensors)``: the elements one block of the kernels
    takes and the tensors one launch takes (read from the library)."""
    chunk, most = ctypes.c_int(), ctypes.c_int()
    _kernel_lib().mt_config(ctypes.byref(chunk), ctypes.byref(most))
    return chunk.value, most.value


def _on(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU tensor (plain)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")


def _dtype_code(name, t, what, device) -> int:
    """The kernels' code of ``t``'s dtype; raises on a tensor they cannot
    take (another device or dtype, not strided)."""
    if t.device != device:
        raise ValueError(f"{name}: {what} on {t.device}, expected {device}")
    code = _DT.get(t.dtype)
    if code is None:
        raise ValueError(f"{name}: {what} dtype {t.dtype} (takes "
                         f"{[str(d) for d in _DT]})")
    if t.layout != torch.strided:
        raise ValueError(f"{name}: {what} must be a strided tensor, got "
                         f"{t.layout}")
    return code


def _scalar(name, device, t, what, dtype, numel=1):
    if t is None:
        return None
    if t.device != device or t.dtype != dtype or t.numel() != numel \
            or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous {dtype} "
                         f"tensor of {numel} element(s) on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def _raise_on(rc: int, name: str, n: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{rc} ({n} tensors)")


def _chunks(numels, chunk) -> int:
    return sum(max(1, -(-k // chunk)) for k in numels)


class _Grads:
    """One call's gradients as the kernels read them: the table column
    of their pointers and dtype codes. A gradient that is not contiguous
    is read from a contiguous copy, written back by :meth:`write_back`
    when the kernel wrote it (O1's unscale)."""
    __slots__ = ("ptrs", "codes", "staged")

    def __init__(self, name, grads, device, numels=None):
        self.ptrs, self.codes, self.staged = [], [], []
        for i, g in enumerate(grads):
            self.codes.append(_dtype_code(name, g, "gradient", device)
                              << _G_SHIFT)
            if numels is not None and g.numel() != numels[i]:
                raise ValueError(f"{name}: gradient {i} has {g.numel()} "
                                 f"elements, its parameter {numels[i]}")
            if not g.is_contiguous():
                c = g.contiguous()
                self.staged.append((g, c))
                g = c
            self.ptrs.append(g.data_ptr())

    def write_back(self):
        for g, c in self.staged:
            g.copy_(c)


def _launch_unscale_norm(name, table, n, chunks, inv_scale, clip, tickets,
                         device) -> UnscaleNorm:
    """O1 over a filled table (gradients in column 1, their codes in
    column 7): fresh results, scratch for its chunks."""
    inv_ptr = _scalar(name, device, inv_scale, "inv_scale", torch.float32)
    kind = _clip_kind(clip)
    partials = torch.empty(chunks, dtype=torch.float32, device=device)
    chunk_bad = torch.empty(chunks, dtype=torch.uint8, device=device)
    tensor_bad = torch.empty(n, dtype=torch.uint8, device=device)
    stats = torch.empty(n + 1, dtype=torch.float32, device=device)
    scale = None
    if kind in (1, 2):
        scale = torch.empty(1 if kind == 1 else n, dtype=torch.float32,
                            device=device)
    found = None
    if inv_ptr is not None:
        found = torch.empty((), dtype=torch.bool, device=device)
    launches = ctypes.c_int(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _kernel_lib().mt_unscale_norm(
        table.ctypes.data, n, inv_ptr, partials.data_ptr(),
        chunk_bad.data_ptr(), tensor_bad.data_ptr(), tickets.data_ptr(),
        stats.data_ptr(), kind if kind in (1, 2) else 0,
        float(clip[1]) if kind in (1, 2) else 0.0,
        None if scale is None else scale.data_ptr(),
        None if found is None else found.data_ptr(),
        ctypes.byref(launches), stream)
    multi_tensor_unscale_norm.launches += launches.value
    _raise_on(rc, name, n)
    return UnscaleNorm(found, scale, stats)


def multi_tensor_unscale_norm(grads: Sequence[torch.Tensor],
                              inv_scale: Optional[torch.Tensor] = None,
                              clip=()) -> UnscaleNorm:
    """Launch O1 over ``grads`` (f32 / bf16 / f16 tensors on one CUDA
    device; its plain version for CPU tensors). ``inv_scale``: a 0-d f32
    tensor, unscale in place and check; ``clip``: a clip spec, whose norm
    kinds get their scale. -> :class:`UnscaleNorm`."""
    name = "multi_tensor_unscale_norm"
    grads = list(grads)
    if not grads:
        raise ValueError(f"{name}: no gradients")
    if not _on(grads[0], name):
        return multi_tensor_unscale_norm_reference(grads, inv_scale, clip)
    dev = grads[0].device
    cols = _Grads(name, grads, dev)
    n = len(grads)
    numels = [g.numel() for g in grads]
    table = np.zeros((n, _COLS), dtype=np.int64)
    table[:, 1] = cols.ptrs
    table[:, 6] = numels
    table[:, 7] = cols.codes
    res = _launch_unscale_norm(
        name, table, n, _chunks(numels, config()[0]), inv_scale, clip,
        torch.zeros(n, dtype=torch.int32, device=dev), dev)
    if inv_scale is not None:
        cols.write_back()
    return res


class AdamTable:
    """O1 and O2 over one parameter list, laid out once.

    Built from the parameters, their moments and beta powers and their
    decays, which a step updates in place, so their pointers stay; each
    step gives only the gradients (:meth:`set_grads`), whose pointers
    change when ``clear_grad`` frees them; :meth:`unscale_norm` and
    :meth:`adam` then launch over them. The constructor checks every
    tensor once and raises on one the kernels cannot take: parameters,
    gradients and moments f32, bf16 or f16 on one CUDA device (a
    parameter's two moments of one dtype), powers one-element f32
    tensors. A parameter or moment that is not contiguous is updated in
    a contiguous copy, copied in before each launch and back after it.
    The table keeps its zeroed tickets (the kernels leave them at zero).
    On CPU tensors both calls run the plain versions."""

    def __init__(self, params, moment1, moment2, beta1_pow, beta2_pow,
                 weight_decays):
        name = "multi_tensor_adam"
        self.cols = [list(c) for c in (params, moment1, moment2, beta1_pow,
                                       beta2_pow)]
        self.wds = [float(w) for w in weight_decays]
        n = self.n = len(self.cols[0])
        if n == 0 or any(len(c) != n for c in self.cols) \
                or len(self.wds) != n:
            raise ValueError(f"{name}: the table's columns must have one "
                             f"entry per parameter (got "
                             f"{[len(c) for c in self.cols]}, "
                             f"{len(self.wds)} decays)")
        self.cuda = _on(self.cols[0][0], name)
        if not self.cuda:
            return
        ps, m1s, m2s, b1s, b2s = self.cols
        dev = self.device = ps[0].device
        self.numels = [p.numel() for p in ps]
        table = self.table = np.zeros((n, _COLS), dtype=np.int64)
        table[:, 6] = self.numels
        self.staged = []      # (user tensor, its contiguous copy)
        codes = []
        for i in range(n):
            code = _dtype_code(name, ps[i], "parameter", dev)
            mc = _dtype_code(name, m1s[i], "moment1", dev)
            if _dtype_code(name, m2s[i], "moment2", dev) != mc \
                    or m1s[i].numel() != self.numels[i] \
                    or m2s[i].numel() != self.numels[i]:
                raise ValueError(
                    f"{name}: entry {i}: a parameter of {self.numels[i]} "
                    f"elements, moments of {m1s[i].numel()} "
                    f"({m1s[i].dtype}) and {m2s[i].numel()} "
                    f"({m2s[i].dtype})")
            codes.append(code | mc << _M_SHIFT
                         | (_USE_WD if self.wds[i] else 0))
            for c, t in ((0, ps[i]), (2, m1s[i]), (3, m2s[i])):
                if not t.is_contiguous():
                    copy = t.contiguous()
                    self.staged.append((t, copy))
                    t = copy
                table[i, c] = t.data_ptr()
            for c, t in ((4, b1s[i]), (5, b2s[i])):
                table[i, c] = _scalar(name, dev, t, "beta power",
                                      torch.float32)
        self.cols = None      # the table holds the pointers
        self.codes = np.asarray(codes, dtype=np.int64)
        self.wd = np.asarray(self.wds, dtype=np.float32)
        self.tickets = torch.zeros(n, dtype=torch.int32, device=dev)
        self.chunks = _chunks(self.numels, config()[0])

    def set_grads(self, grads) -> None:
        """This step's gradients, one per parameter, checked: f32, bf16
        or f16 on the table's device, each of its parameter's size."""
        grads = list(grads)
        if len(grads) != self.n:
            raise ValueError(f"{len(grads)} gradients for {self.n} "
                             f"parameters")
        if not self.cuda:
            self.grads = grads
            return
        self.grads = _Grads("multi_tensor_adam", grads, self.device,
                            self.numels)
        self.table[:, 1] = self.grads.ptrs
        self.table[:, 7] = self.codes | np.asarray(self.grads.codes,
                                                   dtype=np.int64)

    def unscale_norm(self, inv_scale=None, clip=()) -> UnscaleNorm:
        """:func:`multi_tensor_unscale_norm` over the gradients of
        :meth:`set_grads`."""
        if not self.cuda:
            return multi_tensor_unscale_norm_reference(self.grads,
                                                       inv_scale, clip)
        res = _launch_unscale_norm(
            "multi_tensor_unscale_norm", self.table, self.n, self.chunks,
            inv_scale, clip, self.tickets, self.device)
        if inv_scale is not None:
            self.grads.write_back()
        return res

    def adam(self, *, lr, beta1, beta2, epsilon, decoupled, clip=(),
             scale=None, found=()) -> None:
        """:func:`multi_tensor_adam` over this table and the gradients of
        :meth:`set_grads`, in place."""
        name = "multi_tensor_adam"
        if not self.cuda:
            ps, m1s, m2s, b1s, b2s = self.cols
            grads, self.grads = self.grads, None
            return multi_tensor_adam_reference(
                ps, grads, m1s, m2s, b1s, b2s, self.wds, lr=lr,
                beta1=beta1, beta2=beta2, epsilon=epsilon,
                decoupled=decoupled, clip=clip, scale=scale, found=found)
        dev, n = self.device, self.n
        kind = _clip_kind(clip)
        lr_ptr = _scalar(name, dev, lr, "lr", torch.float32)
        scale_ptr = None
        if kind in (1, 2):
            if scale is None:
                raise ValueError(f"{name}: a {clip[0]} clip needs O1's "
                                 f"scale")
            scale_ptr = _scalar(name, dev, scale, "scale", torch.float32,
                                1 if kind == 1 else n)
        flags = [f for f in (found or ()) if f is not None]
        if len(flags) > 2:
            raise ValueError(f"{name}: at most two found flags")
        fptr = [_scalar(name, dev, f, "found", torch.bool) for f in flags]
        fptr += [None] * (2 - len(fptr))
        for t, copy in self.staged:
            copy.copy_(t)
        lo, hi = (float(clip[1]), float(clip[2])) if kind == 3 else (0.0,
                                                                     0.0)
        launches = ctypes.c_int(0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel_lib().mt_adam(
            self.table.ctypes.data, self.wd.ctypes.data, n, lr_ptr,
            scale_ptr, kind, lo, hi, fptr[0], fptr[1], float(beta1),
            float(beta2), float(1 - beta1), float(1 - beta2), float(epsilon),
            int(bool(decoupled)), self.tickets.data_ptr(),
            ctypes.byref(launches), stream)
        multi_tensor_adam.launches += launches.value
        self.grads = None     # the table keeps no gradient past its step
        _raise_on(rc, name, n)
        for t, copy in self.staged:
            t.copy_(copy)


def multi_tensor_adam(params, grads, moment1, moment2, beta1_pow, beta2_pow,
                      weight_decays, *, lr, beta1, beta2, epsilon, decoupled,
                      clip=(), scale=None, found=()) -> None:
    """Launch O2 over the parameter table (its plain version for CPU
    tensors), in place. ``params``, ``grads``, ``moment1``, ``moment2``:
    f32 / bf16 / f16 tensors of equal sizes, one device;
    ``beta1_pow`` / ``beta2_pow``: one-element f32 tensors;
    ``weight_decays``: a float per parameter (0 = no decay); ``lr``: a
    0-d f32 tensor; ``clip``: a clip spec, its norm kinds with O1's
    ``scale``; ``found``: up to two 0-d bool tensors, OR'd. One
    :class:`AdamTable` a call: a caller that steps the same parameters
    again keeps its table instead."""
    table = AdamTable(params, moment1, moment2, beta1_pow, beta2_pow,
                      weight_decays)
    table.set_grads(grads)
    table.adam(lr=lr, beta1=beta1, beta2=beta2, epsilon=epsilon,
               decoupled=decoupled, clip=clip, scale=scale, found=found)


multi_tensor_unscale_norm.launches = 0   # every launch, finalize included
multi_tensor_adam.launches = 0
