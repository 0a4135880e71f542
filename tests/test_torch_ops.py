"""The port's op surface against the JAX package's, on the CPU.

Every function of the five ported op files (``ops/creation.py``,
``ops/math.py``, ``ops/manipulation.py``, ``ops/linalg.py`` up to its
long-tail section, and the ``op_`` variants of ``ops/inplace.py``) runs
on the same numpy-seeded inputs through ``paddle_tpu`` and
``paddle_tpu_torch``: the outputs must agree, and for differentiable
ops so must the gradients of ``sum(out * w)`` (fixed random ``w``)
with respect to every float input — within 1e-5 (f32; 1e-4 for the
decompositions, whose LAPACK paths differ). Dtypes must map, the JAX
package's int32 / float32 standing for the port's int64 / float64 (x64
is off there). Decompositions with a sign freedom are compared through
what is unique (products, magnitudes, eigenvalues). The semantic traps
of the op surface are cases of their own: ``axis`` against ``dim``,
``gather`` as an index select, ``scatter``'s overwrite rule, ``split``
with a -1 section, the sign of ``mod``, ``floor_divide``'s rounding,
the dtypes of ``arange`` and ``argmax``, ``where`` with one argument.
Then the op tables: the same names on both sides, the two kernel rows
pointing at the port's kernels, and every JAX function of the five
files present in the port.
"""

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from test_torch_tensor import _flatten, _norm, port_on_cpu  # noqa: F401

ATOL = RTOL = 1e-5
DECOMP_TOL = 1e-4
DTYPE_ALLOWED = {("int32", "int64"), ("float32", "float64")}


def _a(shape, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _i(values):
    return np.asarray(values, dtype=np.int64)


def _b(values):
    return np.asarray(values, dtype=bool)


POS = dict(lo=0.2, hi=2.0)
UNIT = dict(lo=-0.9, hi=0.9)
SPD = (lambda m: (m @ m.T + 3 * np.eye(3)).astype(np.float32))(_a((3, 3)))
TIES = np.asarray([[3.0, 1.0, 3.0, 2.0, 1.0], [0.5, 0.5, 0.5, 2.0, 2.0]],
                  np.float32)
IMG = _a((1, 2, 4, 5), 3)


def case(name, inputs, fn, grad=True, tol=ATOL):
    return pytest.param(inputs, fn, grad, tol, id=name)


UNARY = [("abs", {}), ("sqrt", POS), ("rsqrt", POS), ("exp", {}),
         ("expm1", {}), ("log", POS), ("log2", POS), ("log10", POS),
         ("log1p", POS), ("sin", {}), ("cos", {}), ("tan", UNIT),
         ("asin", UNIT), ("acos", UNIT), ("atan", {}), ("sinh", {}),
         ("cosh", {}), ("tanh", {}), ("asinh", {}),
         ("acosh", dict(lo=1.2, hi=3.0)), ("atanh", UNIT), ("floor", {}),
         ("ceil", {}), ("round", {}), ("trunc", {}), ("frac", {}),
         ("sign", {}), ("neg", {}), ("reciprocal", POS), ("square", {}),
         ("sigmoid", {}), ("erf", {}), ("erfinv", UNIT), ("lgamma", POS),
         ("digamma", POS), ("angle", {}), ("conj", {}), ("real", {}),
         ("imag", {}), ("isnan", {}), ("isinf", {}), ("isfinite", {})]

BINARY = ["add", "subtract", "multiply", "divide", "mod", "remainder",
          "floor_mod", "maximum", "minimum", "fmax", "fmin", "atan2",
          "hypot", "logaddexp", "floor_divide", "equal", "not_equal",
          "greater_than", "greater_equal", "less_than", "less_equal"]

MATH_CASES = (
    [case(n, [_a((3, 4), 1, **dom)], lambda P, x, n=n: getattr(P, n)(x))
     for n, dom in UNARY]
    + [case(n, [_a((3, 4), 1), _a((4,), 2, lo=0.5, hi=2.0)],
            lambda P, x, y, n=n: getattr(P, n)(x, y)) for n in BINARY]
    + [
        case("mod_sign_int", [_i([7, -7, 5, -5]), _i([3, 3, -3, -3])],
             lambda P, x, y: [P.mod(x, y), P.floor_divide(x, y)], False),
        case("mod_sign_float", [np.float32([7.5, -7.5, 2.0]),
                                 np.float32([-2.0, 2.0, 3.0])],
             lambda P, x, y: [P.mod(x, y), P.floor_divide(x, y)]),
        case("pow", [_a((3, 4), 1, **POS), _a((3, 4), 2)],
             lambda P, x, y: [P.pow(x, y), P.pow(x, 2.0), x ** 3]),
        case("scalar_operands", [_a((3,), 1, **POS)],
             lambda P, x: [P.add(x, 2.0), P.multiply(x, 3),
                           P.subtract(1.0, x), P.divide(1.0, x)]),
        case("logical", [_b([True, False, True]), _b([True, True, False])],
             lambda P, x, y: [P.logical_and(x, y), P.logical_or(x, y),
                              P.logical_xor(x, y), P.logical_not(x)]),
        case("bitwise", [_i([5, 3, 12]), _i([3, 6, 10])],
             lambda P, x, y: [P.bitwise_and(x, y), P.bitwise_or(x, y),
                              P.bitwise_xor(x, y), P.bitwise_not(x)]),
        case("scale_clip_lerp_stanh", [_a((3, 4), 1), _a((3, 4), 2)],
             lambda P, x, y: [P.scale(x, 2.0, 1.0),
                              P.scale(x, 2.0, 1.0, bias_after_scale=False),
                              P.clip(x, -0.5, 0.5), P.clip(x, min=0.1),
                              P.lerp(x, y, 0.3), P.stanh(x)]),
        case("multiply_", [_a((3,), 1), _a((3,), 2)],
             lambda P, x, y: P.multiply_(x, y), False),
        case("sum_mean", [_a((2, 3, 4), 1)],
             lambda P, x: [P.sum(x), P.sum(x, axis=1), P.sum(x, [0, 2]),
                           P.sum(x, -1, keepdim=True), P.mean(x),
                           P.mean(x, axis=[0, 2]), P.mean(x, 1, True)]),
        case("sum_int_dtype", [_i([[1, 2], [3, 4]])],
             lambda P, x: [P.sum(x), P.sum(x, dtype="float32"),
                           P.mean(x)], False),
        case("prod", [_a((2, 3, 4), 1, **POS)],
             lambda P, x: [P.prod(x), P.prod(x, axis=1),
                           P.prod(x, [0, 2], keepdim=True)]),
        case("max_min", [TIES],
             lambda P, x: [P.max(x), P.max(x, axis=1), P.min(x, 0, True),
                           P.amax(x, axis=[0, 1]), P.amin(x, axis=1)]),
        case("squared_l2_norm_std_var", [_a((3, 4), 1)],
             lambda P, x: [P.squared_l2_norm(x), P.std(x), P.var(x, 1),
                           P.std(x, 0, unbiased=False, keepdim=True)]),
        case("median", [_a((3, 4), 1), _a((5,), 2)],
             lambda P, x, y: [P.median(x), P.median(x, axis=1),
                              P.median(y), P.median(x, 0, keepdim=True)]),
        case("logsumexp", [_a((3, 4), 1)],
             lambda P, x: [P.logsumexp(x), P.logsumexp(x, axis=1)]),
        case("cumsum_cumprod", [_a((3, 4), 1, **POS)],
             lambda P, x: [P.cumsum(x), P.cumsum(x, axis=1),
                           P.cumprod(x, dim=0), P.cumprod(x)]),
        case("cummax_cummin", [TIES],
             lambda P, x: [P.cummax(x, axis=1), P.cummin(x, axis=0),
                           P.cummax(x)]),
        case("equal_all_allclose_isclose", [_a((3,), 1), _a((3,), 1)],
             lambda P, x, y: [P.equal_all(x, y), P.allclose(x, y + 1e-9),
                              P.isclose(x, y), P.allclose(x, y + 1.0)],
             False),
        case("all_any", [_b([[True, False], [True, True]])],
             lambda P, x: [P.all(x), P.any(x), P.all(x, axis=1),
                           P.any(x, axis=0, keepdim=True)], False),
        case("argmax_argmin_dtype", [TIES],
             lambda P, x: [P.argmax(x), P.argmax(x, axis=1),
                           P.argmin(x, axis=0, keepdim=True),
                           P.argmax(x, axis=1, dtype="int32")], False),
        case("argsort_sort_ties", [TIES],
             lambda P, x: [P.argsort(x), P.argsort(x, descending=True),
                           P.argsort(x, axis=0), P.sort(x, axis=1),
                           P.sort(x, descending=True)]),
        case("topk_ties", [TIES],
             lambda P, x: [P.topk(x, 2), P.topk(x, 2, largest=False),
                           P.topk(x, 1, axis=0)]),
        case("kthvalue_mode", [TIES],
             lambda P, x: [P.kthvalue(x, 2), P.kthvalue(x, 1, 0, True),
                           P.mode(x), P.mode(x, 0)]),
        case("unique", [_i([3, 1, 3, 2, 1])],
             lambda P, x: [P.unique(x), P.unique(
                 x, return_index=True, return_inverse=True,
                 return_counts=True)], False),
        case("searchsorted", [np.float32([1, 3, 5, 7]),
                              np.float32([0, 3, 6, 9])],
             lambda P, s, v: [P.searchsorted(s, v),
                              P.searchsorted(s, v, right=True),
                              P.searchsorted(s, v, out_int32=True)], False),
        case("index_sample", [_a((3, 4), 1), _i([[0, 2], [1, 1], [3, 0]])],
             lambda P, x, i: P.index_sample(x, i)),
        case("bincount", [_i([0, 1, 1, 3]), np.float32([0.5, 1, 2, 3])],
             lambda P, x, w: [P.bincount(x), P.bincount(x, minlength=6),
                              P.bincount(x, w)], False),
        case("nanmean_nansum_count_nonzero",
             [np.float32([[1, np.nan, 3], [0, 2, np.nan]])],
             lambda P, x: [P.nanmean(x), P.nansum(x, axis=1),
                           P.count_nonzero(x), P.count_nonzero(x, 1)],
             False),
        case("nonzero_where_one_arg", [_i([[0, 3], [5, 0]])],
             lambda P, x: [P.nonzero(x), P.nonzero(x, as_tuple=True),
                           P.where(x)], False),
    ])

CREATION_CASES = [
    case("constants", [_a((2, 3), 1)],
         lambda P, x: [P.zeros([2, 3]), P.ones([2], "int32"),
                       P.full([2, 2], 1.5), P.empty([3]), P.zeros_like(x),
                       P.ones_like(x), P.full_like(x, 2.0),
                       P.empty_like(x, "int64")], False),
    case("arange_dtype", [],
         lambda P: [P.arange(5), P.arange(2, 9, 3), P.arange(0, 1, 0.3),
                    P.arange(4, dtype="float32"), P.linspace(-1, 1, 7),
                    P.eye(3, 2), P.to_tensor([1, 2]),
                    P.get_default_dtype() == P.float32], False),
    case("diag_tril_triu", [_a((4,), 1), _a((3, 3), 2)],
         lambda P, v, m: [P.diag(v), P.diag(v, -1), P.diag(m, 1),
                          P.diag(v, padding_value=2.0), P.tril(m, 1),
                          P.triu(m, -1)]),
    case("meshgrid_assign_clone", [_a((3,), 1), _a((2,), 2)],
         lambda P, a, b: [P.meshgrid(a, b), P.assign(a), P.clone(b)]),
]

MANIP_CASES = [
    case("reshape_transpose", [_a((2, 3, 4), 1)],
         lambda P, x: [P.reshape(x, [6, 4]), P.reshape(x, [-1, 2]),
                       P.transpose(x, [2, 0, 1]), P.moveaxis(x, 0, 2),
                       P.swapaxes(x, 0, 1), P.flatten(x, 1),
                       P.flatten(x, 0, 1)]),
    case("reshape_", [_a((2, 3), 1)],
         lambda P, x: P.reshape_(x, [3, 2]), False),
    case("concat_stack", [_a((2, 3), 1), _a((2, 3), 2)],
         lambda P, x, y: [P.concat([x, y], axis=0), P.concat([x, y], 1),
                          P.stack([x, y]), P.stack([x, y], axis=2)]),
    case("split_minus_one_chunk_unbind", [_a((10, 3), 1)],
         lambda P, x: [P.split(x, 5), P.split(x, [3, 7]),
                       P.split(x, [3, -1]), P.split(x, [1, 2], axis=1),
                       P.chunk(x, 2), P.unbind(x, axis=1)]),
    case("squeeze_unsqueeze", [_a((1, 3, 1, 4), 1)],
         lambda P, x: [P.squeeze(x), P.squeeze(x, axis=0),
                       P.squeeze(x, [0, 2]), P.squeeze(x, 1),
                       P.unsqueeze(x, 0), P.unsqueeze(x, [0, -1]),
                       P.unsqueeze(x, -1)]),
    case("expand_tile_repeat", [_a((1, 3), 1), _a((2, 3), 2)],
         lambda P, x, y: [P.expand(x, [4, 3]), P.expand(x, [2, 4, -1]),
                          P.broadcast_to(x, [2, 3]), P.expand_as(x, y),
                          P.broadcast_tensors([x, y]), P.tile(x, [2, 2]),
                          P.tile(x, [3]), P.repeat_interleave(y, 2, axis=1),
                          P.repeat_interleave(y, 2)]),
    case("flip_roll_rot90", [_a((3, 4), 1)],
         lambda P, x: [P.flip(x, 0), P.flip(x, [0, 1]), P.roll(x, 1),
                       P.roll(x, -2, axis=1), P.rot90(x),
                       P.rot90(x, 2, [1, 0])]),
    case("gather_index_select_on_axis", [_a((5, 3), 1)],
         lambda P, x: [P.gather(x, P.to_tensor([0, 2], dtype="int32")),
                       P.gather(x, P.to_tensor([2, 0]), axis=1),
                       P.gather(x, P.to_tensor([[1], [3]])),
                       P.gather(x, P.to_tensor(4)),
                       P.index_select(x, P.to_tensor([1, 1, 4])),
                       P.index_select(x, P.to_tensor([0, 2]), axis=1)]),
    case("gather_nd_take_put_along", [_a((3, 4), 1), _a((3, 2), 2)],
         lambda P, x, v: [
             P.gather_nd(x, P.to_tensor([[0, 1], [2, 3]])),
             P.take_along_axis(x, P.to_tensor([[0, 3], [1, 1], [2, 0]]),
                               axis=1),
             P.take_along_axis(x, P.to_tensor([[0, 1, 2, 0]]), axis=0),
             P.put_along_axis(x, P.to_tensor([[0, 3], [1, 2], [2, 0]]), v,
                              axis=1),
             P.put_along_axis(x, P.to_tensor([[0, 3], [1, 2], [2, 0]]), v,
                              axis=1, reduce="add")]),
    case("put_along_mul_amax_amin", [_a((3, 4), 1), _a((3, 2), 2)],
         lambda P, x, v: [
             P.put_along_axis(x, P.to_tensor([[0, 3], [1, 2], [2, 0]]), v,
                              axis=1, reduce="mul"),
             P.put_along_axis(x, P.to_tensor([[0, 3], [1, 2], [2, 0]]), v,
                              axis=1, reduce="amax"),
             P.put_along_axis(x, P.to_tensor([[0, 3], [1, 2], [2, 0]]), 0.5,
                              axis=1, reduce="amin")], False),
    case("scatter_overwrite_rule", [_a((5, 3), 1), _a((2, 3), 2)],
         lambda P, x, u: [P.scatter(x, P.to_tensor([0, 2]), u),
                          P.scatter(x, P.to_tensor([3, 1]), u,
                                    overwrite=False),
                          P.scatter(x, P.to_tensor([1, 1]), u,
                                    overwrite=False)]),
    case("scatter_nd", [_a((4, 3), 1), _a((2, 3), 2), _a((2,), 3)],
         lambda P, x, u, w: [
             P.scatter_nd_add(x, P.to_tensor([[1], [1]]), u),
             P.scatter_nd_add(x, P.to_tensor([[0, 1], [3, 2]]), w),
             P.scatter_nd(P.to_tensor([[1], [3]]), u, [5, 3])]),
    case("index_add_put", [_a((4, 3), 1), _a((2, 3), 2), _a((2,), 3)],
         lambda P, x, v, w: [
             P.index_add(x, P.to_tensor([0, 2]), 0, v),
             P.index_put(x, (P.to_tensor([0, 3]), P.to_tensor([1, 2])), w),
             P.index_put(x, (P.to_tensor([1, 1]), P.to_tensor([0, 0])), w,
                         accumulate=True)]),
    case("masked_select", [_a((3, 4), 1)],
         lambda P, x: [P.masked_select(x, x > 0),
                       P.masked_select(x, P.to_tensor([True, False, True,
                                                       False]))], False),
    case("masked_fill_where", [_a((3, 4), 1), _a((3, 4), 2)],
         lambda P, x, y: [P.masked_fill(x, x < 0, 0.5),
                          P.where(x > y, x, y), P.where(x > 0, x, 0.0)]),
    case("pad_modes", [IMG],
         lambda P, x: [P.pad(x, [1, 1, 2, 0]),
                       P.pad(x, [0, 0, 0, 0, 1, 1, 1, 0], value=2.0),
                       P.pad(x, [1, 2, 1, 0], mode="reflect"),
                       P.pad(x, [1, 1, 1, 1], mode="replicate"),
                       P.pad(x, [2, 1, 0, 1], mode="circular")]),
    case("slice_strided_crop", [_a((4, 5, 6), 1)],
         lambda P, x: [P.slice(x, [0, 2], [1, 2], [3, 5]),
                       P.slice(x, [1], [-3], [10]),
                       P.strided_slice(x, [0, 2], [0, 1], [4, 6], [2, 2]),
                       P.strided_slice(x, [1], [4], [0], [-2]),
                       P.crop(x, [2, 2, 3], [1, 2, 0])]),
    case("as_strided", [_a((3, 4), 1)],
         lambda P, x: P.as_strided(x, [2, 2], [4, 1], 1), False),
    case("view_numel", [_a((3, 4), 1)],
         lambda P, x: [P.view(x, [4, 3]), P.view(x, "float16"),
                       P.numel(x)]),
    case("shard_index_diff_atleast", [_i([1, 5, 9, 12]), _a((3, 4), 2)],
         lambda P, i, x: [P.shard_index(i, 16, 2, 1),
                          P.diff(x), P.diff(x, n=2, axis=0),
                          P.diff(x, prepend=0.0, append=1.0),
                          P.atleast_1d(P.to_tensor(1.0)),
                          P.atleast_2d(x[0]), P.atleast_3d(x)]),
    case("tensordot", [_a((2, 3, 4), 1), _a((3, 4, 5), 2)],
         lambda P, x, y: [P.tensordot(x, y), P.tensordot(x, y[:, :, 0], 2),
                          P.tensordot(x, y, [[1], [0]])]),
    case("unfold", [IMG],
         lambda P, x: [P.unfold(x, [2, 3]), P.unfold(x, 2, strides=2,
                                                      paddings=1),
                       P.unfold(x, [2, 2], paddings=[1, 0, 0, 1],
                                dilations=[1, 2])]),
]

LINALG_CASES = [
    case("matmul", [_a((2, 3, 4), 1), _a((2, 4, 5), 2), _a((4,), 3)],
         lambda P, x, y, v: [P.matmul(x, y), P.matmul(x, v),
                             P.matmul(y, x, transpose_x=True,
                                      transpose_y=True),
                             P.bmm(x, y), P.mm(x[0], y[0]), P.mv(x[0], v)]),
    case("products", [_a((3, 4), 1), _a((3, 4), 2), _a((2, 3), 3)],
         lambda P, x, y, z: [P.dot(x, y), P.inner(x, y), P.outer(x, y),
                             P.cross(y[:, :3], x[:, :3]),
                             P.cross(x[:3], y[:3], axis=0), P.t(x),
                             P.kron(z, x), P.einsum("ij,kj->ik", x, y),
                             P.einsum("ij->j", x),
                             P.multi_dot([z, x, P.t(y)])]),
    case("norms", [_a((3, 4), 1), _a((3, 4), 2)],
         lambda P, x, y: [P.norm(x), P.norm(x, axis=1),
                          P.norm(x, "fro", [0, 1]), P.norm(x, 1),
                          P.norm(x, 3, axis=0, keepdim=True),
                          P.norm(x, float("inf"), axis=1),
                          P.norm(x, "inf"), P.norm(x, 1, [0, 1]),
                          P.dist(x, y), P.dist(x, y, 1)]),
    case("transpose_trace_diagonal", [_a((3, 4, 4), 1)],
         lambda P, x: [P.transpose(x, [1, 0, 2]), P.trace(x[0]),
                       P.trace(x, 1, 1, 2), P.diagonal(x, 0, 1, 2),
                       P.diagonal(x[0], -1)]),
    case("solves", [SPD, _a((3, 2), 2), _a((3,), 3)],
         lambda P, a, b, v: [P.inverse(a), P.solve(a, b), P.solve(a, v),
                             P.cholesky(a), P.cholesky(a, upper=True),
                             P.cholesky_solve(b, P.cholesky(a)),
                             P.triangular_solve(P.triu(a), b),
                             P.triangular_solve(P.tril(a), b, upper=False,
                                                transpose=True),
                             P.triangular_solve(P.triu(a), b,
                                                unitriangular=True),
                             P.pinv(a), P.det(a), P.slogdet(a),
                             P.matrix_power(a, 3), P.matrix_power(a, -1)],
         tol=DECOMP_TOL),
    case("decompositions", [_a((4, 3), 1), SPD],
         lambda P, x, s: [P.svd(x)[1], P.matmul(P.svd(x)[0] * P.svd(x)[1],
                                                P.svd(x)[2]),
                          P.abs(P.qr(x)[1]), P.matmul(*P.qr(x)),
                          P.eigh(s)[0], P.abs(P.eigh(s)[1]),
                          P.eigvalsh(s), P.sort(P.eigvals(s)),
                          P.sort(P.eig(s)[0]), P.matrix_rank(x),
                          P.lstsq(x, P.ones([4, 1]))[0]],
         False, DECOMP_TOL),
    case("lstsq", [_a((5, 3), 1), _a((5, 2), 2)],
         lambda P, x, y: list(P.lstsq(x, y))[:3], False, DECOMP_TOL),
    case("stats_householder", [_a((3, 5), 1), _a((4, 3), 2),
                               np.float32([0.5, 0.2, 0.1])],
         lambda P, x, h, tau: [P.corrcoef(x), P.cov(x),
                               P.cov(x, rowvar=False, ddof=False),
                               P.householder_product(h, tau)],
         True, DECOMP_TOL),
]


def _run(P, inputs, fn, grad):
    ts = [P.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
          for a in inputs]
    outs = _flatten(fn(P, *ts))
    if not grad:
        return outs
    rng = np.random.default_rng(99)
    loss = None
    for o in outs:
        if isinstance(o, P.Tensor) and not o.stop_gradient and \
                o.dtype in (P.float32, P.float64):
            w = rng.standard_normal(tuple(o.shape)).astype(np.float32)
            term = (o * P.to_tensor(w)).sum()
            loss = term if loss is None else loss + term
    ins = [t for t in ts if not t.stop_gradient]
    if loss is None:
        return outs + [np.zeros(t.shape, np.float32) for t in ins]
    grads = P.grad(loss, ins, allow_unused=True)
    return outs + [g if g is not None else np.zeros(t.shape, np.float32)
                   for g, t in zip(grads, ins)]


def _check(inputs, fn, grad, tol):
    want = _run(jpaddle, inputs, fn, grad)
    got = _run(tpaddle, inputs, fn, grad)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        (wv, wd), (gv, gd) = _norm(w), _norm(g)
        assert wd == gd or (wd, gd) in DTYPE_ALLOWED or \
            None in (wd, gd), (i, wd, gd)
        assert wv.shape == gv.shape, (i, wv.shape, gv.shape)
        if wv.dtype.kind in "fc" or gv.dtype.kind in "fc":
            np.testing.assert_allclose(gv.astype(np.float64),
                                       wv.astype(np.float64), atol=tol,
                                       rtol=tol, err_msg=f"result {i}")
        else:
            np.testing.assert_array_equal(gv, wv, err_msg=f"result {i}")


@pytest.mark.parametrize("inputs,fn,grad,tol", MATH_CASES)
def test_math_op_matches_jax(inputs, fn, grad, tol):
    _check(inputs, fn, grad, tol)


@pytest.mark.parametrize("inputs,fn,grad,tol", CREATION_CASES)
def test_creation_op_matches_jax(inputs, fn, grad, tol):
    _check(inputs, fn, grad, tol)


@pytest.mark.parametrize("inputs,fn,grad,tol", MANIP_CASES)
def test_manipulation_op_matches_jax(inputs, fn, grad, tol):
    _check(inputs, fn, grad, tol)


@pytest.mark.parametrize("inputs,fn,grad,tol", LINALG_CASES)
def test_linalg_op_matches_jax(inputs, fn, grad, tol):
    _check(inputs, fn, grad, tol)


INPLACE_UNARY = ["abs", "ceil", "cos", "erf", "exp", "expm1", "floor",
                 "neg", "round", "sigmoid", "sin", "square", "tanh",
                 "trunc", "frac"]
INPLACE_POS = ["sqrt", "rsqrt", "log", "log10", "log1p", "log2",
               "reciprocal", "lgamma", "digamma"]
INPLACE_BINARY = ["add", "subtract", "multiply", "divide", "remainder",
                  "mod", "floor_mod", "maximum", "minimum", "hypot"]


@pytest.mark.parametrize("name", INPLACE_UNARY + INPLACE_POS
                         + INPLACE_BINARY)
def test_inplace_variant_matches_jax(name):
    """``x.op_(...)`` and the top-level ``paddle.op_(x, ...)`` leave in
    ``x`` what ``op`` returns."""
    def scenario(P):
        x = _a((3, 4), 1, **(POS if name in INPLACE_POS else {}))
        y = _a((3, 4), 2, lo=0.5, hi=2.0)
        args = [P.to_tensor(y)] if name in INPLACE_BINARY else []
        t = P.to_tensor(x)
        out = getattr(t, name + "_")(*args)
        u = P.to_tensor(x)
        if hasattr(jpaddle, name + "_"):
            getattr(P, name + "_")(u, *args)
        return [t, u, out is t]
    _check_scenario(scenario)


def test_inplace_other_variants_match_jax():
    def scenario(P):
        x = P.to_tensor(_a((2, 3), 1))
        outs = []
        for name, args in (("clip_", (-0.5, 0.5)), ("scale_", (2.0, 1.0)),
                           ("cumsum_", (1,)), ("tril_", ()),
                           ("triu_", (1,)), ("lerp_", (P.ones([2, 3]),
                                                       0.5)),
                           ("unsqueeze_", (0,)), ("squeeze_", (0,)),
                           ("flatten_", ()), ("cast_", ("int32",))):
            getattr(x, name)(*args)
            outs.append(x.numpy().copy())
        return outs
    _check_scenario(scenario)


def _check_scenario(scenario):
    want, got = _flatten(scenario(jpaddle)), _flatten(scenario(tpaddle))
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        (wv, _), (gv, _) = _norm(w), _norm(g)
        np.testing.assert_allclose(gv, wv, atol=ATOL, rtol=RTOL,
                                   err_msg=f"result {i}")


def test_random_creation_shapes_and_dtypes():
    for P in (jpaddle, tpaddle):
        P.seed(3)
        outs = [P.rand([2, 3]), P.uniform([4], min=-2.0, max=-1.0),
                P.randn([3]), P.normal(0.0, 1.0, [5]),
                P.randint(2, 6, [7]), P.randperm(6),
                P.multinomial(P.to_tensor([0.2, 0.8]), 4, True),
                P.bernoulli(P.full([3], 0.5))]
        shapes = [o.shape for o in outs]
        assert shapes == [[2, 3], [4], [3], [5], [7], [6], [4], [3]]
        u = outs[1].numpy()
        assert ((u >= -2) & (u < -1)).all()
        r = outs[4].numpy()
        assert ((r >= 2) & (r < 6)).all()
        assert sorted(outs[5].tolist()) == list(range(6))


# -- the op tables -------------------------------------------------------

def test_op_tables_hold_the_same_names():
    from paddle_tpu.ops import op_registry as jreg
    from paddle_tpu_torch.ops import op_registry as treg
    assert set(treg.OP_TABLE) == set(jreg.OP_TABLE)
    assert treg.num_ops() == jreg.num_ops()
    for name, info in jreg.OP_TABLE.items():
        mine = treg.OP_TABLE[name]
        for key in ("nin", "nargs", "has_vjp", "variadic", "fusable",
                    "shape_spec"):
            assert mine[key] == info[key], (name, key)
        if not info["module"].startswith("ops.pallas."):
            assert mine["module"] == info["module"], name


def test_kernel_rows_point_at_the_port_kernels():
    from paddle_tpu_torch.ops import op_registry as treg
    from paddle_tpu_torch.ops.kernels import flash_attention, grouped_matmul
    assert treg.get_op_info("grouped_matmul")["module"] == \
        "ops.kernels.grouped_matmul"
    assert treg.get_op_info("flash_attention_segmented")["module"] == \
        "ops.kernels.flash_attention"
    assert treg.resolve("grouped_matmul") is grouped_matmul.grouped_matmul
    assert treg.resolve("flash_attention_segmented") is \
        flash_attention.flash_attention_segmented


def test_unported_rows_are_listed_not_dropped():
    from paddle_tpu_torch.ops import op_registry as treg
    missing = set(treg.unported())
    assert {"ring_attention"} <= missing
    for name in ("matmul", "add", "reshape", "arange", "gelu", "linear",
                 "layer_norm", "cross_entropy", "fused_softmax_ce_mean",
                 "grouped_matmul", "einsum", "topk", "sinc",
                 "fused_rms_norm"):
        assert name not in missing, name
    assert missing < set(treg.OP_TABLE)


@pytest.mark.parametrize("module", ["creation", "math", "manipulation",
                                    "linalg", "extra_math"])
def test_port_has_every_jax_function(module):
    import importlib
    jmod = importlib.import_module(f"paddle_tpu.ops.{module}")
    tmod = importlib.import_module(f"paddle_tpu_torch.ops.{module}")
    names = []
    for name, fn in vars(jmod).items():
        if name.startswith("_") or not callable(fn) or \
                getattr(fn, "__module__", None) != jmod.__name__:
            continue
        names.append(name)
    if module == "creation":
        names += ["to_tensor", "get_default_dtype"]
    missing = [n for n in names if not callable(getattr(tmod, n, None))]
    assert not missing, missing
    assert all(hasattr(tpaddle, n) for n in names)
