"""Shape/dtype abstract interpreter for the static capture planner.

The port of ``paddle_tpu/analysis/shapes.py``. Every op ``ops.yaml``
marks ``fusable:`` declares a ``shape:`` spec (``elementwise``,
``broadcast``, ``reduce``, ``matmul``, ``linear``, ``cast``,
``attention``) saying how its output's ``(shape, dtype)`` follows from
its inputs' and its attributes; :func:`abstract_eval` evaluates one op
by its spec, with the JAX module's arithmetic (torch's dtype promotion
agrees with JAX's on the float and mixed float pairs the specs are
graded on). :func:`validate_specs` grades every declared spec against
the port's LIVE op (``op_registry.resolve``) run on ``meta`` tensors —
shapes and dtypes without data or device — on sample inputs, and checks
both marker directions; a disagreement is **PTC005**. An op whose
function the port lacks (``ring_attention``, item 13) is skipped, as
the JAX module skips an op without a registered impl.
:func:`bucketed_leaf_signatures` counts the distinct signatures a
``BucketPolicy`` admits for a dynamic axis: the bounded set of captured
programs a PTC004 row cites.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .diagnostics import Diagnostic

__all__ = ["AVal", "abstract_eval", "validate_specs", "validate_op",
           "bucketed_leaf_signatures", "dtype_of"]


def dtype_of(d) -> torch.dtype:
    """A torch dtype from a torch dtype, a name or a numpy / JAX dtype
    (``"bfloat16"``, ``np.float32`` ...)."""
    if isinstance(d, torch.dtype):
        return d
    name = getattr(d, "name", None) or str(np.dtype(d)
                                            if not isinstance(d, str)
                                            else d)
    return getattr(torch, name)


class AVal(tuple):
    """Abstract value: ``(shape, dtype)`` with a torch dtype. A plain
    tuple subclass so signatures hash and compare structurally."""

    __slots__ = ()

    def __new__(cls, shape, dtype):
        return tuple.__new__(cls, (tuple(int(d) for d in shape),
                                   dtype_of(dtype)))

    @property
    def shape(self):
        return self[0]

    @property
    def dtype(self):
        return self[1]

    def __repr__(self):
        return f"AVal({list(self.shape)}, {str(self.dtype)[6:]})"


def _promote(*dtypes) -> torch.dtype:
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out


def _broadcast_shapes(*shapes) -> Optional[Tuple[int, ...]]:
    try:
        return tuple(int(d) for d in np.broadcast_shapes(*shapes))
    except ValueError:
        return None


def _attrs_dict(attrs) -> Dict[str, Any]:
    return dict(attrs) if attrs else {}


# -- per-spec evaluators ------------------------------------------------------

def _ew_eval(avals, attrs):
    """elementwise: unary, shape AND dtype preserved (the strongest
    invariant — a planner can propagate it with zero uncertainty)."""
    if len(avals) != 1:
        return None
    return AVal(avals[0].shape, avals[0].dtype)


def _bcast_eval(avals, attrs):
    """broadcast: n-ary elementwise with numpy broadcasting + dtype
    promotion (add/multiply/maximum/...)."""
    if not avals:
        return None
    shape = _broadcast_shapes(*[a.shape for a in avals])
    if shape is None:
        return None
    return AVal(shape, _promote(*[a.dtype for a in avals]))


def _reduce_eval(avals, attrs):
    """reduce: axis (None | int | tuple) / keepdim / optional dtype
    attrs — exactly the fuse_attrs the reduction wrappers pass."""
    if len(avals) != 1:
        return None
    a = avals[0]
    kw = _attrs_dict(attrs)
    axis = kw.get("axis")
    keepdim = bool(kw.get("keepdim", False))
    ndim = len(a.shape)
    if axis is None:
        axes = tuple(range(ndim))
    else:
        axes = axis if isinstance(axis, (tuple, list)) else (axis,)
        axes = tuple(ax + ndim if ax < 0 else ax for ax in axes)
        if any(not 0 <= ax < ndim for ax in axes) and ndim > 0:
            return None
    if ndim == 0:
        shape: Tuple[int, ...] = ()
    elif keepdim:
        shape = tuple(1 if i in axes else d
                      for i, d in enumerate(a.shape))
    else:
        shape = tuple(d for i, d in enumerate(a.shape)
                      if i not in axes)
    dtype = kw.get("dtype")
    return AVal(shape, dtype_of(dtype) if dtype is not None else a.dtype)


def _matmul_shape(sa, sb):
    """matmul shape arithmetic (numpy's, torch's): 1-D operands get a dim prepended/
    appended (and dropped from the result), batch dims broadcast."""
    if not sa or not sb:
        return None  # 0-d operands don't contract
    a1 = len(sa) == 1
    b1 = len(sb) == 1
    if a1:
        sa = (1,) + sa
    if b1:
        sb = sb + (1,)
    if sa[-1] != sb[-2]:
        return None
    batch = _broadcast_shapes(sa[:-2], sb[:-2])
    if batch is None:
        return None
    out = batch + (sa[-2], sb[-1])
    if b1:
        out = out[:-1]
    if a1:
        out = out[:-1] if b1 else out[:-2] + out[-1:]
    return out


def _matmul_eval(avals, attrs):
    """matmul: transpose_x/transpose_y attrs swap the last two dims of
    >1-D operands, then the matmul rules."""
    if len(avals) != 2:
        return None
    kw = _attrs_dict(attrs)
    sa, sb = avals[0].shape, avals[1].shape
    if kw.get("transpose_x") and len(sa) > 1:
        sa = sa[:-2] + (sa[-1], sa[-2])
    if kw.get("transpose_y") and len(sb) > 1:
        sb = sb[:-2] + (sb[-1], sb[-2])
    shape = _matmul_shape(sa, sb)
    if shape is None:
        return None
    return AVal(shape, _promote(avals[0].dtype, avals[1].dtype))


def _linear_eval(avals, attrs):
    """linear: x[..., in] @ w[in, out] (+ optional b broadcast over the
    result) with paddle's [in, out] weight layout."""
    if len(avals) not in (2, 3):
        return None
    x, w = avals[0], avals[1]
    if len(w.shape) != 2 or not x.shape or x.shape[-1] != w.shape[0]:
        return None
    shape = x.shape[:-1] + (w.shape[1],)
    dts = [x.dtype, w.dtype]
    if len(avals) == 3:
        b = avals[2]
        shape2 = _broadcast_shapes(shape, b.shape)
        if shape2 is None:
            return None
        shape = shape2
        dts.append(b.dtype)
    return AVal(shape, _promote(*dts))


def _cast_eval(avals, attrs):
    """cast: shape preserved, dtype from the node's `dtype` attr."""
    if len(avals) != 1:
        return None
    kw = _attrs_dict(attrs)
    if kw.get("dtype") is None:
        return None
    return AVal(avals[0].shape, dtype_of(kw["dtype"]))


def _attention_eval(avals, attrs):
    """attention: q/k/v ``[B, S, H, D]`` (plus optional integer
    segment ids ``[B, S]`` — the varlen-packing variant). The output
    follows the QUERY aval exactly: same shape, same dtype (the
    in-tree kernels take uniform q/k/v dtypes and cast the context
    product back to the query's). KV length may differ from the query
    length (cache decode verifies short queries over long keys)."""
    if len(avals) not in (3, 4):
        return None
    q, k, v = avals[0], avals[1], avals[2]
    if len(q.shape) != 4 or k.shape != v.shape or len(k.shape) != 4:
        return None
    # batch, heads and head_dim must agree; only the sequence axis may
    # differ between query and key/value
    if (q.shape[0], q.shape[2], q.shape[3]) != \
            (k.shape[0], k.shape[2], k.shape[3]):
        return None
    if len(avals) == 4:
        seg = avals[3]
        if seg.dtype.is_floating_point or seg.dtype.is_complex or \
                seg.shape != (q.shape[0], q.shape[1]):
            return None
    return AVal(q.shape, q.dtype)


_EVALUATORS = {
    "elementwise": _ew_eval,
    "broadcast": _bcast_eval,
    "reduce": _reduce_eval,
    "matmul": _matmul_eval,
    "linear": _linear_eval,
    "cast": _cast_eval,
    "attention": _attention_eval,
}


def _spec_of(op: str) -> Optional[str]:
    from ..ops.op_registry import OP_TABLE
    info = OP_TABLE.get(op)
    return info.get("shape_spec") if info else None


def abstract_eval(op: str, avals: Sequence[AVal],
                  attrs=None) -> Optional[AVal]:
    """Evaluate one op over abstract values via its declared ``shape:``
    spec. Returns None when the op has no spec or the spec rejects the
    inputs (rank/contraction mismatch) — callers fall back to the live
    ground truth (:func:`live_eval`)."""
    spec = _spec_of(op)
    if spec is None:
        return None
    avals = [a if isinstance(a, AVal) else AVal(a[0], a[1])
             for a in avals]
    return _EVALUATORS[spec](avals, attrs)


# -- golden-run validation (PTC005) ------------------------------------------

# sample avals per spec id: the inexact training domain plus mixed-
# promotion pairs; (avals, attrs) cases, each graded abstract-vs-live
_F32 = torch.float32
_BF16 = torch.bfloat16


def _sample_cases(op: str, spec: str) -> List[Tuple[list, Any]]:
    if spec == "elementwise":
        return [([((3, 4), _F32)], None), ([((2, 1, 5), _BF16)], None),
                ([((), _F32)], None)]
    if spec == "broadcast":
        return [([((3, 4), _F32), ((4,), _F32)], None),
                ([((3, 4), _BF16), ((3, 4), _F32)], None),
                ([((3, 1), _F32), ((1, 5), _BF16)], None)]
    if spec == "reduce":
        if op == "squared_l2_norm":   # fixed full reduction, no attrs
            return [([((3, 4), _F32)], ()), ([((5,), _BF16)], ())]
        cases = []
        for axis, keepdim in ((None, False), (1, False), (1, True),
                              ((0, 2), False), (-1, True)):
            av = ((2, 3, 4), _F32) if isinstance(axis, tuple) or axis \
                else ((3, 4), _F32)
            attrs = (("axis", axis), ("keepdim", keepdim))
            if op in ("sum", "prod"):   # their wrappers carry a dtype
                attrs = (("axis", axis), ("dtype", None),
                         ("keepdim", keepdim))
            cases.append(([av], attrs))
        if op in ("sum", "prod"):
            cases.append(([((3, 4), _BF16)],
                          (("axis", None), ("dtype", _F32),
                           ("keepdim", False))))
        return cases
    if spec == "matmul":
        return [
            ([((3, 4), _F32), ((4, 5), _F32)],
             (("transpose_x", False), ("transpose_y", False))),
            ([((4, 3), _F32), ((4, 5), _BF16)],
             (("transpose_x", True), ("transpose_y", False))),
            ([((2, 3, 4), _BF16), ((2, 4, 5), _BF16)],
             (("transpose_x", False), ("transpose_y", False))),
            ([((4,), _F32), ((4, 5), _F32)],
             (("transpose_x", False), ("transpose_y", False))),
            ([((3, 4), _F32), ((4,), _F32)],
             (("transpose_x", False), ("transpose_y", False))),
        ]
    if spec == "linear":
        return [([((2, 3, 4), _F32), ((4, 5), _F32)], ()),
                ([((2, 4), _BF16), ((4, 5), _BF16), ((5,), _BF16)], ()),
                ([((2, 4), _BF16), ((4, 5), _F32), ((5,), _F32)], ())]
    if spec == "cast":
        return [([((3, 4), _F32)], (("dtype", _BF16),)),
                ([((2,), _BF16)], (("dtype", _F32),)),
                ([((3,), _F32)], (("dtype", torch.int32),))]
    if spec == "attention":
        # uniform q/k/v dtypes (the kernel contract); graded through
        # the registered parametric impls (the real entry points)
        _I32 = torch.int32
        if op == "flash_attention_segmented":
            return [([((2, 8, 4, 16), _F32)] * 3 + [((2, 8), _I32)],
                     ()),
                    ([((1, 16, 2, 8), _BF16)] * 3 + [((1, 16), _I32)],
                     ())]
        cases = [([((2, 8, 4, 16), _F32)] * 3, ()),
                 ([((1, 16, 2, 8), _BF16)] * 3, ())]
        if op == "flash_attention":
            # cache-decode geometry: 1 query row over a longer KV
            cases.append(([((2, 1, 4, 16), _F32),
                           ((2, 8, 4, 16), _F32),
                           ((2, 8, 4, 16), _F32)], ()))
        return cases
    return []


def _call(op: str, spec: str, fn, args, kw):
    """The port's op on meta tensors, in the calling convention of its
    spec's attributes."""
    if spec == "reduce":
        if op == "squared_l2_norm":
            return fn(args[0])
        kw = {k: v for k, v in kw.items() if not (k == "dtype" and v is None)}
        return fn(args[0], **kw)
    if spec == "cast":
        return fn(args[0], kw["dtype"])
    if spec == "matmul":
        return fn(args[0], args[1], **kw)
    if spec == "attention":
        out = fn(*args)
        return out[0] if isinstance(out, (tuple, list)) else out
    return fn(*args)


def live_eval(op: str, avals: Sequence[AVal], attrs=None,
              spec: Optional[str] = None) -> Optional[AVal]:
    """The output ``(shape, dtype)`` of the port's live op on ``meta``
    tensors of ``avals`` with ``attrs``; None when the port lacks the
    op."""
    from ..ops.op_registry import resolve
    fn = resolve(op)
    if fn is None:
        return None
    from ..core.tensor import Tensor
    spec = spec or _spec_of(op)
    args = [torch.empty(a.shape, dtype=a.dtype, device="meta")
            for a in avals]
    if spec != "attention":   # the kernels' entries take torch tensors
        args = [Tensor(t) for t in args]
    out = _call(op, spec, fn, args, _attrs_dict(attrs))
    t = getattr(out, "_t", out)
    return AVal(t.shape, t.dtype)


def validate_op(op: str, spec: Optional[str] = None) -> List[Diagnostic]:
    """Grade one op's shape spec against its live op on the sample
    inputs (PTC005 on a disagreement or an op that fails on them).
    ``spec`` overrides the declared one: the self-check seeds a wrong
    spec this way to prove the detector fires."""
    declared = _spec_of(op)
    spec = spec or declared
    if spec is None:
        return []
    evaluator = _EVALUATORS.get(spec)
    if evaluator is None:
        return [Diagnostic(
            "PTC005", f"ops/ops.yaml: {op}",
            f"op `{op}` declares shape spec {spec!r} which "
            f"analysis/shapes.py implements no evaluator for",
            hint="pick a spec from the evaluators of analysis/shapes.py")]
    diags: List[Diagnostic] = []
    # sample from the DECLARED spec (its cases carry the op's real
    # attrs) and grade with the spec under test
    for avals, attrs in _sample_cases(op, declared or spec):
        avals = [AVal(s, d) for s, d in avals]
        try:
            want = live_eval(op, avals, attrs, declared or spec)
        except Exception as e:  # noqa: BLE001 — the op's own failure
            diags.append(Diagnostic(
                "PTC005", f"ops/ops.yaml: {op}",
                f"the live op `{op}` fails on meta inputs {avals} attrs "
                f"{attrs!r}: {type(e).__name__}: {e}",
                hint="the spec cannot be graded against an op that "
                     "does not run on its own sample inputs"))
            break
        if want is None:
            break  # not ported: nothing to grade
        got = evaluator(avals, attrs)
        if got is None or tuple(got) != tuple(want):
            diags.append(Diagnostic(
                "PTC005", f"ops/ops.yaml: {op}",
                f"shape spec `{spec}` predicts {got!r} for inputs "
                f"{avals} attrs {attrs!r}, but the live op produces "
                f"{want!r}",
                hint="fix the spec (or the op) — the capture planner "
                     "plans from this arithmetic; the two must agree"))
            break  # one counterexample per op keeps reports readable
    return diags


def validate_specs() -> List[Diagnostic]:
    """The PTC005 sweep: both marker directions plus the golden-run
    agreement check for every declared spec."""
    from ..ops.op_registry import OP_TABLE
    diags: List[Diagnostic] = []
    for name, info in sorted(OP_TABLE.items()):
        spec = info.get("shape_spec")
        fusable = info.get("fusable")
        if fusable and not spec:
            diags.append(Diagnostic(
                "PTC005", f"ops/ops.yaml: {name}",
                f"op `{name}` is marked fusable:{fusable!r} but carries "
                f"no `shape:` spec — the abstract interpreter cannot "
                f"plan regions containing it",
                hint="declare one of op_registry.SHAPE_SPECS"))
            continue
        if spec and not fusable:
            diags.append(Diagnostic(
                "PTC005", f"ops/ops.yaml: {name}",
                f"op `{name}` declares shape spec `{spec}` but is not "
                f"fusable — dead declaration (the interpreter only "
                f"walks fusable regions)",
                hint="mark the op fusable, or drop the spec"))
            continue
        if spec:
            diags.extend(validate_op(name, spec))
    return diags


# -- bucketing ----------------------------------------------------------------

def bucketed_leaf_signatures(shape, dynamic_axes: Dict[int, Any],
                             max_size: int,
                             dtype="float32") -> List[Tuple]:
    """The bounded-executables proof for one leaf: enumerate the
    distinct ``(shape, dtype)`` signatures a bucket policy admits when
    each axis in ``dynamic_axes`` (axis -> buckets, a sorted list or
    "pow2" — BucketPolicy's vocabulary) sweeps sizes ``1..max_size``.
    Without a policy that sweep compiles ``max_size`` distinct
    programs per axis; with it, ``len(result)`` — the number the
    capture plan quotes for a PTC004 row."""
    from ..jit.sot import BucketPolicy
    policy = BucketPolicy({})
    per_axis: Dict[int, List[int]] = {}
    for axis, buckets in dynamic_axes.items():
        per_axis[axis] = sorted(
            {policy.bucket_of(s, buckets)
             for s in range(1, int(max_size) + 1)})
    sigs = {tuple(shape)}
    for axis, sizes in per_axis.items():
        sigs = {s[:axis] + (n,) + s[axis + 1:]
                for s in sigs for n in sizes}
    return sorted((s, str(dtype_of(dtype))[6:]) for s in sigs)
