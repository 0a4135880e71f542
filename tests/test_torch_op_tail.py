"""The op surface's tail against the JAX package, on the CPU: every public
function of ``ops/extra_math.py`` (its ``__all__``, at the package root),
the linalg tail and ``paddle_tpu_torch.linalg``, the four loss rows with
their layers, the long-tail layers of ``nn/layers_extra.py``,
``incubate.nn.functional``, ``flash_attn_qkvpacked`` and
``flashmask_attention``, the root namespace's tail and the small
helpers.

Each deterministic function takes the same seeded f32 inputs on both
sides: outputs within TOL·(1 + |ref|), TOL = 1e-4 (f32; the special
functions are computed by other series on the two sides), integer and
bool outputs equal, and where a case names differentiable inputs the
gradient of ``Σ out · w`` (``w`` fixed random weights) too. The random
ops (and the dropouts) draw other bits than JAX's: they are held to
their shapes, dtypes, ranges and moments, and to the port's seed. The
decompositions are compared through what they reconstruct.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.ops import extra_math as jextra
from paddle_tpu_torch.ops import extra_math as textra
from test_torch_tensor import port_on_cpu  # noqa: F401

TOL = 1e-4
_R = np.random.default_rng(21)


def _f(*shape, lo=None, hi=None):
    if lo is not None:
        return _R.uniform(lo, hi, shape).astype(np.float32)
    return _R.standard_normal(shape).astype(np.float32)


def _np(v):
    if isinstance(v, jpaddle.Tensor):
        return np.asarray(v._data)
    if isinstance(v, tpaddle.Tensor):
        return v.numpy()
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v)


def _outs(res):
    if isinstance(res, (tuple, list)):
        return [o for r in res for o in _outs(r)]
    return [res]


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu" or got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    if want.dtype.kind == "c":
        got, want = np.stack([got.real, got.imag]), \
            np.stack([want.real, want.imag])
    got = np.atleast_1d(got.astype(np.float64))
    want = np.atleast_1d(want.astype(np.float64))
    both_nan = np.isnan(got) & np.isnan(want)
    assert (np.isnan(got) == np.isnan(want)).all(), what
    err = np.abs(got - want) - tol * (1 + np.abs(want))
    err[both_nan | (got == want)] = 0
    assert (err <= 0).all(), (what, float(np.nanmax(np.abs(got - want))))


def _check(name, fn, arrays, diff=(), tol=TOL):
    """``fn(P, *tensors)`` on both sides: outputs, and with ``diff`` the
    gradients of Σ out·w with respect to those inputs."""
    jt = [jpaddle.to_tensor(a, stop_gradient=i not in diff)
          for i, a in enumerate(arrays)]
    tt = [tpaddle.to_tensor(a, stop_gradient=i not in diff)
          for i, a in enumerate(arrays)]
    jo, to = _outs(fn(jpaddle, *jt)), _outs(fn(tpaddle, *tt))
    assert len(jo) == len(to), name
    for i, (g, w) in enumerate(zip(to, jo)):
        _close(_np(g), _np(w), f"{name} out {i}", tol)
    if not diff:
        return
    rng = np.random.default_rng(3)
    ws = [rng.standard_normal(_np(o).shape).astype(np.float32) for o in jo]

    def total(P, outs):
        s = None
        for o, w in zip(outs, ws):
            term = (o.astype("float32") * P.to_tensor(w)).sum()
            s = term if s is None else s + term
        return s
    total(jpaddle, jo).backward()
    total(tpaddle, to).backward()
    for i in diff:
        _close(_np(tt[i].grad), _np(jt[i].grad), f"{name} grad {i}", tol)


X = _f(4, 7)
Y = _f(4, 7)
POS = np.abs(_f(4, 7)) + 0.5
A = _f(6, 6) + 6 * np.eye(6, dtype=np.float32)
INTS = _R.integers(1, 40, (4, 7)).astype(np.int32)

# (name, fn(P, *tensors), arrays, differentiable inputs)
MATH = [
    ("addmm", lambda P, i, a, b: P.addmm(i, a, b, 0.5, 2.0),
     [_f(4, 4), X, Y.T.copy()], (0, 1, 2)),
    ("add_n", lambda P, a, b: P.add_n([a, b]), [X, Y], (0, 1)),
    ("logit", lambda P, a: P.logit(a, eps=0.1), [_f(4, 7, lo=0.05, hi=0.95)],
     (0,)),
    ("logcumsumexp", lambda P, a: P.logcumsumexp(a, axis=1), [X], (0,)),
    ("logcumsumexp_flat", lambda P, a: P.logcumsumexp(a), [X], (0,)),
    ("sinc", lambda P, a: P.sinc(a), [X], (0,)),
    ("heaviside", lambda P, a, b: P.heaviside(a, b),
     [np.where(X > 0.5, 0.0, X).astype(np.float32), Y], ()),
    ("nan_to_num", lambda P, a: P.nan_to_num(a, posinf=9.0),
     [np.array([np.nan, np.inf, -np.inf, 1.5], np.float32)], ()),
    ("sgn", lambda P, a: P.sgn(a), [X], ()),
    ("copysign", lambda P, a, b: P.copysign(a, b), [X, Y], (0,)),
    ("nextafter", lambda P, a, b: P.nextafter(a, b), [X, Y], ()),
    ("frexp", lambda P, a: P.frexp(a), [X], ()),
    ("ldexp", lambda P, a, b: P.ldexp(a, b), [X, INTS % 5], ()),
    ("rad2deg", lambda P, a: P.rad2deg(a), [X], (0,)),
    ("deg2rad", lambda P, a: P.deg2rad(a), [X], (0,)),
    ("gcd", lambda P, a, b: P.gcd(a, b), [INTS, INTS[::-1].copy()], ()),
    ("lcm", lambda P, a, b: P.lcm(a, b), [INTS % 9 + 1, INTS % 7 + 1], ()),
    ("gammaln", lambda P, a: P.gammaln(a), [POS], (0,)),
    ("gammainc", lambda P, a, b: P.gammainc(a, b), [POS, POS + 0.3], ()),
    ("gammaincc", lambda P, a, b: P.gammaincc(a, b), [POS, POS + 0.3], ()),
    ("multigammaln", lambda P, a: P.multigammaln(a, 3), [POS + 2], (0,)),
    ("polygamma", lambda P, a: P.polygamma(a, 0), [POS], (0,)),
    ("polygamma_n2", lambda P, a: P.polygamma(a, 2), [POS], ()),
    ("i0", lambda P, a: P.i0(a), [X], ()),
    ("i0e", lambda P, a: P.i0e(a), [X], ()),
    ("i1", lambda P, a: P.i1(a), [X], ()),
    ("i1e", lambda P, a: P.i1e(a), [X], ()),
    ("trapezoid", lambda P, a: P.trapezoid(a, dx=0.5), [X], (0,)),
    ("trapezoid_x", lambda P, a, b: P.trapezoid(a, b, axis=1),
     [X, np.cumsum(POS, 1)], (0,)),
    ("cumulative_trapezoid", lambda P, a: P.cumulative_trapezoid(a), [X],
     (0,)),
    ("cumulative_trapezoid_x", lambda P, a, b: P.cumulative_trapezoid(
        a, b, axis=0), [X, np.cumsum(POS, 0)], (0,)),
    ("quantile", lambda P, a: P.quantile(a, [0.25, 0.9], axis=1), [X], ()),
    ("quantile_all", lambda P, a: P.quantile(a, 0.3), [X], ()),
    ("nanquantile", lambda P, a: P.nanquantile(a, 0.5, axis=0,
                                               keepdim=True),
     [np.where(X > 1, np.nan, X).astype(np.float32)], ()),
    ("nanmedian", lambda P, a: P.nanmedian(a, axis=1),
     [np.where(X > 1, np.nan, X).astype(np.float32)], ()),
    ("renorm", lambda P, a: P.renorm(a, 2.0, 0, 1.0), [X], (0,)),
    ("reduce_as", lambda P, a, b: P.reduce_as(a, b), [_f(3, 4, 7),
                                                     _f(1, 7)], (0,)),
    ("complex", lambda P, a, b: P.complex(a, b), [X, Y], ()),
    ("as_complex", lambda P, a: P.as_complex(a), [_f(4, 2)], ()),
    ("as_real", lambda P, a: P.as_real(P.as_complex(a)), [_f(4, 2)], ()),
    ("polar", lambda P, a, b: P.polar(a, b), [POS, X], ()),
    ("hstack", lambda P, a, b: P.hstack([a, b]), [X, Y], (0,)),
    ("vstack", lambda P, a, b: P.vstack([a, b]), [X, Y], (0,)),
    ("row_stack", lambda P, a, b: P.row_stack([a, b]), [X, Y], ()),
    ("dstack", lambda P, a, b: P.dstack([a, b]), [X, Y], ()),
    ("column_stack", lambda P, a, b: P.column_stack([a, b]), [X[0], Y[0]],
     ()),
    ("tensor_split", lambda P, a: P.tensor_split(a, 3, axis=1), [X], (0,)),
    ("tensor_split_idx", lambda P, a: P.tensor_split(a, [1, 5], axis=1),
     [X], ()),
    ("hsplit", lambda P, a: P.hsplit(a, [2, 3]), [X], ()),
    ("vsplit", lambda P, a: P.vsplit(a, 2), [X], ()),
    ("dsplit", lambda P, a: P.dsplit(a, 2), [_f(2, 3, 4)], ()),
    ("unstack", lambda P, a: P.unstack(a, axis=1), [X], (0,)),
    ("unflatten", lambda P, a: P.unflatten(a, 1, [2, 3]), [_f(4, 6)], ()),
    ("view_as", lambda P, a, b: P.view_as(a, b), [X, _f(7, 4)], ()),
    ("reverse", lambda P, a: P.reverse(a, [0, 1]), [X], (0,)),
    ("block_diag", lambda P, a, b: P.block_diag([a, b]), [X, _f(2, 3)],
     (0,)),
    ("diagflat", lambda P, a: P.diagflat(a, 1), [_f(4)], ()),
    ("diag_embed", lambda P, a: P.diag_embed(a, -1), [X], (0,)),
    ("vander", lambda P, a: P.vander(a, 4, True), [_f(5)], ()),
    ("cartesian_prod", lambda P, a, b: P.cartesian_prod([a, b]),
     [_f(3), _f(2)], ()),
    ("combinations", lambda P, a: P.combinations(a, 3), [_f(5)], ()),
    ("combinations_rep", lambda P, a: P.combinations(a, 2, True), [_f(4)],
     ()),
    ("slice_scatter", lambda P, a, v: P.slice_scatter(a, v, [1], [0], [6],
                                                      [2]),
     [X, _f(4, 3)], ()),
    ("select_scatter", lambda P, a, v: P.select_scatter(a, v, 1, 2),
     [X, _f(4)], ()),
    ("diagonal_scatter", lambda P, a, v: P.diagonal_scatter(a, v, 1),
     [_f(5, 5), _f(4)], ()),
    ("index_fill", lambda P, a, i: P.index_fill(a, i, 0, -1.0),
     [X, np.array([0, 2])], ()),
    ("masked_scatter", lambda P, a, m, v: P.masked_scatter(a, m, v),
     [X, X > 0, _f(28)], ()),
    ("multiplex", lambda P, i, a, b: P.multiplex([a, b], i),
     [np.array([[1], [0], [1], [0]], np.int32), X, Y], ()),
    ("take_clip", lambda P, a, i: P.take(a, i, mode="clip"),
     [X, np.array([[0, 40], [-3, 5]])], ()),
    ("take_wrap", lambda P, a, i: P.take(a, i, mode="wrap"),
     [X, np.array([[0, 40], [-3, 5]])], ()),
    ("take", lambda P, a, i: P.take(a, i), [X, np.array([3, 27, 0])], ()),
    ("bucketize", lambda P, a, s: P.bucketize(a, s, right=True),
     [X, np.sort(_f(6))], ()),
    ("bucketize_i32", lambda P, a, s: P.bucketize(a, s, out_int32=True),
     [X, np.sort(_f(6))], ()),
    ("cdist", lambda P, a, b: P.cdist(a, b), [X, Y[:3]], (0, 1)),
    ("cdist_p1", lambda P, a, b: P.cdist(a, b, p=1.0), [X, Y[:3]], ()),
    ("pdist", lambda P, a: P.pdist(a), [X], (0,)),
    ("bitwise_left_shift", lambda P, a, b: P.bitwise_left_shift(a, b),
     [INTS, INTS % 4], ()),
    ("bitwise_right_shift", lambda P, a, b: P.bitwise_right_shift(a, b),
     [INTS - 20, INTS % 4], ()),
    ("bitwise_right_shift_logical", lambda P, a, b: P.bitwise_right_shift(
        a, b, is_arithmetic=False), [INTS - 20, INTS % 4], ()),
    ("isin", lambda P, a, b: P.isin(a, b), [INTS, INTS[0]], ()),
    ("isin_invert", lambda P, a, b: P.isin(a, b, invert=True),
     [INTS, INTS[0]], ()),
    ("isposinf", lambda P, a: P.isposinf(a),
     [np.array([np.inf, -np.inf, 1.0], np.float32)], ()),
    ("isneginf", lambda P, a: P.isneginf(a),
     [np.array([np.inf, -np.inf, 1.0], np.float32)], ()),
    ("isreal", lambda P, a: P.isreal(a), [X], ()),
    ("signbit", lambda P, a: P.signbit(a), [X], ()),
    ("is_empty", lambda P, a: P.is_empty(a), [np.zeros((0, 3), np.float32)],
     ()),
    ("histogram", lambda P, a: P.histogram(a, bins=5, min=-2, max=2), [X],
     ()),
    ("histogram_auto", lambda P, a: P.histogram(a, bins=4), [X], ()),
    ("histogram_weighted", lambda P, a, w: P.histogram(
        a, bins=4, min=-2, max=2, weight=w), [X, POS], ()),
    ("histogram_bin_edges", lambda P, a: P.histogram_bin_edges(a, bins=6),
     [X], ()),
    ("histogramdd", lambda P, a: P.histogramdd(a, bins=3), [_f(20, 2)],
     ()),
    ("unique_consecutive", lambda P, a: P.unique_consecutive(
        a, return_inverse=True, return_counts=True),
     [np.array([1, 1, 2, 2, 3, 1, 1, 2], np.float32)], ()),
]


@pytest.mark.parametrize("name,fn,arrays,diff", MATH,
                         ids=[c[0] for c in MATH])
def test_extra_math_matches_jax(name, fn, arrays, diff):
    _check(name, fn, arrays, diff)


INFO = [
    ("broadcast_shape", lambda P: P.broadcast_shape([3, 1, 4], [5, 1])),
    ("is_tensor", lambda P: (P.is_tensor(P.to_tensor(X)),
                             P.is_tensor(X))),
    ("is_complex", lambda P: (P.is_complex(P.to_tensor(X)),
                              P.is_complex(P.complex(P.to_tensor(X),
                                                     P.to_tensor(Y))))),
    ("is_integer", lambda P: (P.is_integer(P.to_tensor(INTS)),
                              P.is_integer(P.to_tensor(X)))),
    ("is_floating_point", lambda P: (P.is_floating_point(P.to_tensor(X)),
                                     P.is_floating_point(
                                         P.to_tensor(INTS)))),
    ("tril_indices", lambda P: _np(P.tril_indices(4, 5, 1)).tolist()),
    ("triu_indices", lambda P: _np(P.triu_indices(4, None, -1)).tolist()),
    ("logspace", lambda P: np.round(_np(P.logspace(0, 2, 5)), 3).tolist()),
]


@pytest.mark.parametrize("name,fn", INFO, ids=[c[0] for c in INFO])
def test_extra_math_info_matches_jax(name, fn):
    assert fn(tpaddle) == fn(jpaddle), name


def test_every_extra_math_name_is_ported_and_at_the_root():
    assert textra.__all__ == jextra.__all__
    assert len(set(textra.__all__)) == len(textra.__all__) == 90
    for name in textra.__all__:
        assert getattr(tpaddle, name) is getattr(textra, name), name
    named = {c[0].split("_")[0] for c in MATH} | {c[0] for c in MATH} | \
        {c[0] for c in INFO} | set(RANDOM)
    missing = [n for n in textra.__all__ if n not in named]
    assert not missing, missing


RANDOM = {
    "standard_normal": lambda P: P.standard_normal([4000]),
    "standard_gamma": lambda P: P.standard_gamma(
        P.to_tensor(np.full(4000, 3.0, np.float32))),
    "poisson": lambda P: P.poisson(P.to_tensor(np.full(4000, 4.0,
                                                       np.float32))),
    "log_normal": lambda P: P.log_normal(0.0, 0.5, [4000]),
    "randint_like": lambda P: P.randint_like(P.to_tensor(np.zeros(
        4000, np.float32)), 3, 9),
}
# (mean, std) of each draw, and its dtype
MOMENTS = {"standard_normal": (0.0, 1.0), "standard_gamma": (3.0, 3 ** 0.5),
           "poisson": (4.0, 2.0), "log_normal": (np.exp(0.125), None),
           "randint_like": (5.5, None)}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_ops_follow_their_law_and_the_seed(name):
    tpaddle.seed(7)
    a = RANDOM[name](tpaddle)
    tpaddle.seed(7)
    b = RANDOM[name](tpaddle)
    np.testing.assert_array_equal(_np(a), _np(b))
    j = RANDOM[name](jpaddle)
    assert _np(a).shape == _np(j).shape and _np(a).dtype == _np(j).dtype
    mean, std = MOMENTS[name]
    v = _np(a).astype(np.float64)
    assert abs(v.mean() - mean) < 0.1 * (1 + abs(mean)), (name, v.mean())
    if std is not None:
        assert abs(v.std() - std) < 0.1 * std, (name, v.std())
    if name == "randint_like":
        assert v.min() >= 3 and v.max() <= 8


# -- linalg ------------------------------------------------------------------

SPD = (A @ A.T).astype(np.float32)
CHOL = np.linalg.cholesky(SPD).astype(np.float32)
QR_H, QR_TAU = np.linalg.qr(_f(6, 4), mode="raw")
QR_H, QR_TAU = QR_H.T.astype(np.float32).copy(), QR_TAU.astype(np.float32)

LINALG = [
    ("inv", lambda P, a: P.linalg.inv(a), [A], (0,)),
    ("cond", lambda P, a: P.linalg.cond(a), [A], ()),
    ("cond_fro", lambda P, a: P.linalg.cond(a, p="fro"), [A], ()),
    ("matrix_exp", lambda P, a: P.linalg.matrix_exp(a), [A / 8], ()),
    ("matrix_exp_batched", lambda P, a: P.linalg.matrix_exp(a),
     [_f(2, 3, 3) / 3], ()),
    ("matrix_norm_fro", lambda P, a: P.linalg.matrix_norm(a), [X], (0,)),
    ("matrix_norm_nuc", lambda P, a: P.linalg.matrix_norm(a, p="nuc"), [X],
     ()),
    ("matrix_norm_2", lambda P, a: P.linalg.matrix_norm(a, p=2), [X], ()),
    ("matrix_norm_inf", lambda P, a: P.linalg.matrix_norm(a, p=np.inf),
     [X], ()),
    ("vector_norm", lambda P, a: P.linalg.vector_norm(a), [X], (0,)),
    ("vector_norm_axis", lambda P, a: P.linalg.vector_norm(
        a, p=3, axis=1, keepdim=True), [X], (0,)),
    ("vector_norm_axes", lambda P, a: P.linalg.vector_norm(
        a, p=1, axis=[0, 2]), [_f(2, 3, 4)], ()),
    ("ormqr", lambda P, h, t, y: P.linalg.ormqr(h, t, y),
     [QR_H, QR_TAU, _f(6, 3)], ()),
    ("ormqr_right_t", lambda P, h, t, y: P.linalg.ormqr(
        h, t, y, left=False, transpose=True), [QR_H, QR_TAU, _f(3, 6)], ()),
    ("cholesky_inverse", lambda P, a: P.linalg.cholesky_inverse(a), [CHOL],
     ()),
    ("fp8_fp8_half_gemm_fused", lambda P, a, b, c: P.linalg
     .fp8_fp8_half_gemm_fused(a, b, transpose_y=True, bias=c, scale=0.5,
                              act="relu", output_dtype="float32"),
     [np.round(_f(8, 16) * 2), np.round(_f(4, 16) * 2), _f(4)], ()),
]


@pytest.mark.parametrize("name,fn,arrays,diff", LINALG,
                         ids=[c[0] for c in LINALG])
def test_linalg_tail_matches_jax(name, fn, arrays, diff):
    _check(name, fn, arrays, diff)


@pytest.mark.parametrize("P", [jpaddle, tpaddle], ids=["jax", "port"])
def test_decompositions_reconstruct(P):
    """lu / lu_unpack: P L U = A, pivots 1-based int32; svd_lowrank at
    full rank and pca_lowrank reconstruct their inputs."""
    lu, piv = P.linalg.lu(P.to_tensor(A))
    assert _np(piv).dtype == np.int32 and _np(piv).min() >= 1
    p_, l_, u_ = P.linalg.lu_unpack(lu, piv)
    _close(_np(p_) @ _np(l_) @ _np(u_), A, "lu")
    _, _, info = P.linalg.lu(P.to_tensor(A), get_infos=True)
    assert int(_np(info)) == 0
    M = _f(8, 5)
    u, s, v = P.linalg.svd_lowrank(P.to_tensor(M), q=5)
    _close((_np(u) * _np(s)) @ _np(v).T, M, "svd_lowrank", 1e-4)
    u, s, v = P.linalg.pca_lowrank(P.to_tensor(M), q=5)
    _close((_np(u) * _np(s)) @ _np(v).T, M - M.mean(0), "pca_lowrank",
           1e-4)


def test_lu_matches_jax():
    j = [_np(t) for t in jpaddle.linalg.lu(jpaddle.to_tensor(A))]
    t = [_np(x) for x in tpaddle.linalg.lu(tpaddle.to_tensor(A))]
    _close(t[0], j[0], "lu")
    np.testing.assert_array_equal(t[1], j[1])
    jp = [_np(x) for x in jpaddle.linalg.lu_unpack(
        jpaddle.to_tensor(j[0]), jpaddle.to_tensor(j[1]))]
    tp = [_np(x) for x in tpaddle.linalg.lu_unpack(
        tpaddle.to_tensor(t[0]), tpaddle.to_tensor(t[1]))]
    for a, b, n in zip(tp, jp, "PLU"):
        _close(a, b, n)


def test_linalg_module_reexports_the_ops():
    import paddle_tpu_torch.linalg as tl
    from paddle_tpu_torch.ops import linalg as ol
    for name in ol.__all__:
        assert getattr(tl, name) is getattr(ol, name), name
    assert tpaddle.linalg is tl


# -- losses, layers, fused functionals, attention ------------------------------

LOSSES = [
    ("hsigmoid_loss", lambda P, x, l, w, b: P.nn.functional.hsigmoid_loss(
        x, l, 6, w, b), [_f(5, 8), _R.integers(0, 6, (5,)), _f(5, 8),
                         _f(5, 1)], (0, 2, 3)),
    ("hsigmoid_loss_custom", lambda P, x, l, w, t, c: P.nn.functional
     .hsigmoid_loss(x, l, 4, w, None, t, c),
     [_f(3, 8), np.array([0, 1, 2]), _f(4, 8),
      np.array([[0, 1, -1], [0, 2, 3], [1, 3, -1]]),
      np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0]])], (0, 2)),
    ("rnnt_loss", lambda P, a, lb, tl, ul: P.nn.functional.rnnt_loss(
        a, lb, tl, ul, reduction="none"),
     [_f(2, 6, 4, 5), _R.integers(1, 5, (2, 3)).astype(np.int32),
      np.array([6, 5], np.int32), np.array([3, 2], np.int32)], (0,)),
    ("rnnt_loss_mean", lambda P, a, lb, tl, ul: P.nn.functional.rnnt_loss(
        a, lb, tl, ul, fastemit_lambda=0.0),
     [_f(2, 5, 3, 4), _R.integers(1, 4, (2, 2)).astype(np.int32),
      np.array([5, 4], np.int32), np.array([2, 1], np.int32)], (0,)),
    ("margin_cross_entropy", lambda P, a, l: P.nn.functional
     .margin_cross_entropy(a, l, return_softmax=True, reduction="sum"),
     [_f(5, 7, lo=-0.9, hi=0.9), _R.integers(0, 7, (5,))], (0,)),
    ("margin_cross_entropy_none", lambda P, a, l: P.nn.functional
     .margin_cross_entropy(a, l, 1.35, 0.0, 0.1, 30.0, reduction=None),
     [_f(5, 7, lo=-0.9, hi=0.9), _R.integers(0, 7, (5, 1))], (0,)),
    ("adaptive_log_softmax_with_loss", lambda P, x, y, h, a1, a2, b1, b2:
     P.nn.functional.adaptive_log_softmax_with_loss(
         x, y, h, [[a1, a2], [b1, b2]], [4, 8]),
     [_f(6, 8), _R.integers(0, 12, (6,)), _f(8, 6), _f(8, 4), _f(4, 4),
      _f(8, 2), _f(2, 4)], (0, 2, 3, 4, 5, 6)),
]


@pytest.mark.parametrize("name,fn,arrays,diff", LOSSES,
                         ids=[c[0] for c in LOSSES])
def test_loss_rows_match_jax(name, fn, arrays, diff):
    _check(name, fn, arrays, diff)


def test_margin_cross_entropy_refuses_a_group_of_ranks():
    class Group:
        nranks = 2
    with pytest.raises(NotImplementedError, match="collectives"):
        tpaddle.nn.functional.margin_cross_entropy(
            tpaddle.to_tensor(_f(2, 3)), tpaddle.to_tensor(np.array([0, 1])),
            group=Group())


FUSED = [
    ("fused_linear", lambda P, a, w, b: P.incubate.nn.functional
     .fused_linear(a, w, b), [X, _f(7, 3), _f(3)], (0, 1, 2)),
    ("fused_linear_t", lambda P, a, w: P.incubate.nn.functional
     .fused_linear(a, w, transpose_weight=True), [X, _f(3, 7)], (0, 1)),
    ("fused_dropout_add_eval", lambda P, a, b: P.incubate.nn.functional
     .fused_dropout_add(a, b, 0.3, training=False), [X, Y], (0, 1)),
    ("fused_dropout_add_infer", lambda P, a, b: P.incubate.nn.functional
     .fused_dropout_add(a, b, 0.3, training=False,
                        mode="downscale_in_infer"), [X, Y], ()),
    ("fused_rms_norm", lambda P, a, w, b: P.incubate.nn.functional
     .fused_rms_norm(a, w, b), [X, _f(7), _f(7)], (0, 1, 2)),
    ("fused_layer_norm", lambda P, a, w, b: P.incubate.nn.functional
     .fused_layer_norm(a, w, b, begin_norm_axis=1), [X, _f(7), _f(7)],
     (0, 1, 2)),
    ("fused_bias_act_gelu", lambda P, a, b: P.incubate.nn.functional
     .fused_bias_act(a, b), [X, _f(7)], (0, 1)),
    ("fused_bias_act_relu", lambda P, a: P.incubate.nn.functional
     .fused_bias_act(a, act_method="relu"), [X], ()),
    ("fused_bias_act_silu", lambda P, a: P.incubate.nn.functional
     .fused_bias_act(a, act_method="silu"), [X], (0,)),
    ("fused_bias_act_swiglu", lambda P, a: P.incubate.nn.functional
     .fused_bias_act(a, act_method="swiglu"), [_f(4, 8)], (0,)),
    ("swiglu", lambda P, a, b: P.incubate.nn.functional.swiglu(a, b),
     [X, Y], (0, 1)),
    ("swiglu_halves", lambda P, a: P.incubate.nn.functional.swiglu(a),
     [_f(4, 8)], (0,)),
    ("fused_rope_neox", lambda P, q, k: P.incubate.nn.functional
     .fused_rotary_position_embedding(q, k)[:2],
     [_f(2, 5, 2, 8), _f(2, 5, 2, 8)], (0, 1)),
    ("fused_rope_interleaved_pos", lambda P, q, p: P.incubate.nn.functional
     .fused_rotary_position_embedding(q, position_ids=p,
                                      use_neox_rotary_style=False)[0],
     [_f(2, 5, 2, 8), _R.integers(0, 20, (2, 5))], (0,)),
    ("fused_rope_tables", lambda P, q, s, c, p: P.incubate.nn.functional
     .fused_rotary_position_embedding(q, sin=s, cos=c, position_ids=p)[0],
     [_f(2, 5, 2, 8), _f(1, 9, 1, 8), _f(1, 9, 1, 8),
      _R.integers(0, 9, (2, 5))], (0,)),
    ("fused_layernorm_residual_dropout", lambda P, a, r, w, b: P.incubate
     .nn.functional.fused_layernorm_residual_dropout(a, r, w, b, p=0.0),
     [X, Y, _f(7), _f(7)], (0, 1, 2, 3)),
]


@pytest.mark.parametrize("name,fn,arrays,diff", FUSED,
                         ids=[c[0] for c in FUSED])
def test_fused_functionals_match_jax(name, fn, arrays, diff):
    _check(name, fn, arrays, diff)


def test_fused_dropouts_drop_in_training():
    tpaddle.seed(3)
    F = tpaddle.incubate.nn.functional
    x, y = tpaddle.to_tensor(np.ones((64, 64), np.float32)), \
        tpaddle.to_tensor(np.zeros((64, 64), np.float32))
    out = _np(F.fused_dropout_add(x, y, 0.25))
    kept = out != 0
    assert 0.65 < kept.mean() < 0.85
    np.testing.assert_allclose(out[kept], 1 / 0.75, rtol=1e-6)
    o, s = F.fused_layernorm_residual_dropout(x, y, p=0.25)
    assert 0.65 < (_np(s) != 0).mean() < 0.85


ATTN = [
    ("flash_attn_qkvpacked", lambda P, qkv: P.nn.functional
     .flash_attn_qkvpacked(qkv, causal=True)[0], [_f(2, 9, 3, 2, 16)],
     (0,)),
    ("flashmask_causal_c1", lambda P, q, k, v, se: P.nn.functional
     .flashmask_attention(q, k, v, se, causal=True),
     [_f(2, 8, 2, 16), _f(2, 8, 2, 16), _f(2, 8, 2, 16),
      _R.integers(4, 9, (2, 1, 8, 1))], (0, 1, 2)),
    ("flashmask_causal_c2", lambda P, q, k, v, se: P.nn.functional
     .flashmask_attention(q, k, v, se, causal=True),
     [_f(2, 8, 2, 16), _f(2, 8, 2, 16), _f(2, 8, 2, 16),
      np.concatenate([_R.integers(4, 6, (2, 2, 8, 1)),
                      _R.integers(6, 9, (2, 2, 8, 1))], -1)], (0,)),
    ("flashmask_bidirectional_c2", lambda P, q, k, v, se: P.nn.functional
     .flashmask_attention(q, k, v, se),
     [_f(2, 8, 2, 16), _f(2, 8, 2, 16), _f(2, 8, 2, 16),
      np.concatenate([_R.integers(5, 9, (2, 1, 8, 1)),
                      _R.integers(0, 2, (2, 1, 8, 1))], -1)], (0,)),
    ("flashmask_bidirectional_c4_window", lambda P, q, k, v, se: P.nn
     .functional.flashmask_attention(q, k, v, se, window_size=(3, 2)),
     [_f(2, 8, 2, 16), _f(2, 8, 2, 16), _f(2, 8, 2, 16),
      np.concatenate([_R.integers(6, 8, (2, 1, 8, 1)),
                      np.full((2, 1, 8, 1), 8),
                      np.zeros((2, 1, 8, 1), np.int64),
                      _R.integers(0, 2, (2, 1, 8, 1))], -1)], (0,)),
]


@pytest.mark.parametrize("name,fn,arrays,diff", ATTN,
                         ids=[c[0] for c in ATTN])
def test_attention_entries_match_jax(name, fn, arrays, diff):
    _check(name, fn, arrays, diff)


def _layer_twin(jl, tl):
    from paddle_tpu_torch.convert import load_layer_from_jax
    load_layer_from_jax(tl, {n: np.asarray(p._data)
                             for n, p in jl.named_parameters()})
    return tl


LAYERS = [
    ("PairwiseDistance", lambda P: P.nn.PairwiseDistance(p=3.0), [X, Y]),
    ("Softmax2D", lambda P: P.nn.Softmax2D(), [_f(2, 3, 4, 5)]),
    ("Unflatten", lambda P: P.nn.Unflatten(1, [2, 3]), [_f(4, 6)]),
    ("ZeroPad1D", lambda P: P.nn.ZeroPad1D([1, 2]), [_f(2, 3, 5)]),
    ("ZeroPad3D", lambda P: P.nn.ZeroPad3D(1), [_f(1, 2, 3, 3, 3)]),
    ("LPPool1D", lambda P: P.nn.LPPool1D(2, 3, 2), [np.abs(_f(2, 3, 9))]),
    ("LPPool2D", lambda P: P.nn.LPPool2D(3, 2), [np.abs(_f(2, 3, 6, 6))]),
    ("TripletMarginWithDistanceLoss",
     lambda P: P.nn.TripletMarginWithDistanceLoss(margin=0.5, swap=True),
     [X, Y, _f(4, 7)]),
    ("RNNTLoss", lambda P: P.nn.RNNTLoss(reduction="sum"),
     [_f(2, 6, 4, 5), _R.integers(1, 5, (2, 3)).astype(np.int32),
      np.array([6, 5], np.int32), np.array([3, 2], np.int32)]),
    ("FeatureAlphaDropout_eval", lambda P: P.nn.FeatureAlphaDropout(0.3)
     .eval() or P.nn.FeatureAlphaDropout(0.3), [X]),
]


@pytest.mark.parametrize("name,make,arrays", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_extra_layers_match_jax(name, make, arrays):
    jl, tl = make(jpaddle), make(tpaddle)
    if name.endswith("_eval"):
        jl.eval()
        tl.eval()
    _check(name, lambda P, *xs: (jl if P is jpaddle else tl)(*xs), arrays)


def test_max_unpool_layers_match_jax():
    x = _f(2, 3, 8, 8)
    for P in (jpaddle, tpaddle):
        pooled, idx = P.nn.functional.max_pool2d(P.to_tensor(x), 2,
                                                 return_mask=True)
        out = P.nn.MaxUnPool2D(2)(pooled, idx)
        if P is jpaddle:
            want = _np(out)
        else:
            _close(_np(out), want, "MaxUnPool2D")
    x1 = _f(2, 3, 8)
    for P in (jpaddle, tpaddle):
        pooled, idx = P.nn.functional.max_pool1d(P.to_tensor(x1), 2,
                                                 return_mask=True)
        out = P.nn.MaxUnPool1D(2)(pooled, idx)
        if P is jpaddle:
            want = _np(out)
        else:
            _close(_np(out), want, "MaxUnPool1D")
    x3 = _f(1, 2, 4, 4, 4)
    for P in (jpaddle, tpaddle):
        pooled, idx = P.nn.functional.max_pool3d(P.to_tensor(x3), 2,
                                                 return_mask=True)
        out = P.nn.MaxUnPool3D(2)(pooled, idx)
        if P is jpaddle:
            want = _np(out)
        else:
            _close(_np(out), want, "MaxUnPool3D")


def test_fractional_max_pool_layers_given_u_match_jax():
    x = _f(2, 3, 9, 9)
    x3 = _f(1, 2, 7, 7, 7)
    for cls, arr, size in (("FractionalMaxPool2D", x, 4),
                           ("FractionalMaxPool3D", x3, 3)):
        outs = []
        for P in (jpaddle, tpaddle):
            layer = getattr(P.nn, cls)(size, random_u=0.3, return_mask=True)
            outs.append([_np(o) for o in layer(P.to_tensor(arr))])
        for a, b in zip(outs[1], outs[0]):
            _close(a, b, cls)
    layer = tpaddle.nn.FractionalMaxPool2D(4)
    assert layer(tpaddle.to_tensor(x)).shape == [2, 3, 4, 4]


def test_feature_alpha_dropout_layer_trains_and_passes_through():
    tpaddle.seed(1)
    layer = tpaddle.nn.FeatureAlphaDropout(0.5)
    x = tpaddle.to_tensor(np.ones((8, 16, 4, 4), np.float32))
    out = _np(layer(x))
    per_map = out.reshape(8, 16, -1)
    assert (per_map == per_map[..., :1]).all()    # one mask a feature map
    assert len(np.unique(np.round(per_map[..., 0], 5))) == 2
    layer.eval()
    np.testing.assert_array_equal(_np(layer(x)), _np(x))


def test_hsigmoid_loss_layer_matches_jax():
    jpaddle.seed(4)
    jl = jpaddle.nn.HSigmoidLoss(8, 6)
    tl = _layer_twin(jl, tpaddle.nn.HSigmoidLoss(8, 6))
    assert sorted(n for n, _ in jl.named_parameters()) == \
        sorted(n for n, _ in tl.named_parameters()) == ["bias", "weight"]
    x, lbl = _f(5, 8), _R.integers(0, 6, (5,))
    _close(_np(tl(tpaddle.to_tensor(x), tpaddle.to_tensor(lbl))),
           _np(jl(jpaddle.to_tensor(x), jpaddle.to_tensor(lbl))), "hsig")
    nb = tpaddle.nn.HSigmoidLoss(8, 6, bias_attr=False)
    assert nb.bias is None
    with pytest.raises(ValueError):
        tpaddle.nn.HSigmoidLoss(8, 1)


def test_adaptive_log_softmax_layer_matches_jax():
    jpaddle.seed(6)
    jl = jpaddle.nn.AdaptiveLogSoftmaxWithLoss(8, 12, [4, 8], div_value=2.0,
                                               head_bias=True)
    tl = _layer_twin(jl, tpaddle.nn.AdaptiveLogSoftmaxWithLoss(
        8, 12, [4, 8], div_value=2.0, head_bias=True))
    x, y = _f(6, 8), _R.integers(0, 12, (6,))
    for a, b in zip(tl(tpaddle.to_tensor(x), tpaddle.to_tensor(y)),
                    jl(jpaddle.to_tensor(x), jpaddle.to_tensor(y))):
        _close(_np(a), _np(b), "forward")
    _close(_np(tl.log_prob(tpaddle.to_tensor(x))),
           _np(jl.log_prob(jpaddle.to_tensor(x))), "log_prob")
    np.testing.assert_array_equal(_np(tl.predict(tpaddle.to_tensor(x))),
                                  _np(jl.predict(jpaddle.to_tensor(x))))
    with pytest.raises(ValueError):
        tpaddle.nn.AdaptiveLogSoftmaxWithLoss(8, 12, [4, 4])


# -- the root namespace's tail and the helpers ---------------------------------

def test_root_tail_matches_jax():
    for d in ("float32", "bfloat16", "float16", "float64"):
        j, t = jpaddle.finfo(d), tpaddle.finfo(d)
        for attr in ("bits", "eps", "max", "min", "tiny"):
            assert float(getattr(t, attr)) == float(getattr(j, attr)), \
                (d, attr)
    for d in ("int8", "int16", "int32", "uint8"):
        j, t = jpaddle.iinfo(d), tpaddle.iinfo(d)
        assert (t.bits, t.min, t.max) == (j.bits, int(j.min), int(j.max))
    x = _f(2, 3, 4)
    assert int(_np(tpaddle.rank(tpaddle.to_tensor(x)))) == int(
        _np(jpaddle.rank(jpaddle.to_tensor(x))))
    assert _np(tpaddle.shape(tpaddle.to_tensor(x))).tolist() == \
        _np(jpaddle.shape(jpaddle.to_tensor(x))).tolist()
    assert tpaddle.in_dynamic_mode() is True
    tpaddle.disable_static()
    with pytest.raises(NotImplementedError, match="item 15"):
        tpaddle.enable_static()
    for name in ("is_compiled_with_cinn", "is_compiled_with_rocm",
                 "is_compiled_with_xpu", "disable_signal_handler"):
        assert getattr(tpaddle, name)() == getattr(jpaddle, name)()
    assert tpaddle.check_shape(x) is None
    with tpaddle.LazyGuard() as g:
        assert isinstance(g, tpaddle.LazyGuard)
    assert tpaddle.CUDAPinnedPlace() is not None
    reader = lambda: iter(range(7))                       # noqa: E731
    assert list(tpaddle.batch(reader, 3)()) == list(jpaddle.batch(reader,
                                                                  3)())
    assert list(tpaddle.batch(reader, 3, drop_last=True)()) == \
        list(jpaddle.batch(reader, 3, drop_last=True)())
    assert tpaddle.tolist(tpaddle.to_tensor([[1, 2]])) == [[1, 2]]
    assert tpaddle.float8_e4m3fn is torch.float8_e4m3fn
    assert tpaddle.dtype is torch.dtype
    state = tpaddle.get_cuda_rng_state()
    a = _np(tpaddle.standard_normal([3]))
    tpaddle.set_cuda_rng_state(state)
    np.testing.assert_array_equal(_np(tpaddle.standard_normal([3])), a)
    tpaddle.set_printoptions(precision=4)
    tpaddle.set_printoptions(precision=8)


def test_root_inplace_tail():
    i, a, b = _f(3, 3), _f(3, 4), _f(4, 3)
    for P in (jpaddle, tpaddle):
        t = P.to_tensor(i)
        out = P.addmm_(t, P.to_tensor(a), P.to_tensor(b), 0.5, 2.0)
        assert out is t
        if P is jpaddle:
            want = _np(t)
        else:
            _close(_np(t), want, "addmm_")
    c = X > 0
    for P in (jpaddle, tpaddle):
        x = P.to_tensor(X)
        assert P.where_(P.to_tensor(c), x, P.to_tensor(Y)) is x
        _close(_np(x), np.where(c, X, Y), "where_")
    tpaddle.seed(0)
    t = tpaddle.to_tensor(np.zeros(4000, np.float32))
    tpaddle.normal_(t, 1.0, 2.0)
    assert abs(_np(t).mean() - 1.0) < 0.15 and abs(_np(t).std() - 2) < 0.15
    for name in ("bernoulli_", "cauchy_", "geometric_", "log_normal_"):
        assert getattr(tpaddle, name)(
            tpaddle.to_tensor(np.full(8, 0.5, np.float32)), *(
                (0.5,) if name == "geometric_" else ())) is not None
    # the extra_math rows' in-place forms
    for name in ("sinc_", "copysign_", "gammaln_", "logit_", "nan_to_num_",
                 "renorm_", "lcm_", "gcd_", "i0_"):
        assert hasattr(tpaddle, name) and hasattr(tpaddle.Tensor, name), \
            name
    x = tpaddle.to_tensor(X)
    tpaddle.sinc_(x)
    _close(_np(x), np.sinc(X), "sinc_")


def test_binomial_draws_counts():
    tpaddle.seed(2)
    n = tpaddle.to_tensor(np.full(4000, 10.0, np.float32))
    p = tpaddle.to_tensor(np.full(4000, 0.3, np.float32))
    out = tpaddle.binomial(n, p)
    v = _np(out)
    assert v.dtype == np.int64 and v.min() >= 0 and v.max() <= 10
    assert abs(v.mean() - 3.0) < 0.2
    j = jpaddle.binomial(jpaddle.to_tensor(np.full(4, 10.0, np.float32)),
                         jpaddle.to_tensor(np.full(4, 0.3, np.float32)))
    # the JAX package narrows int64 to int32 (x64 off)
    assert (_np(j).dtype.name, v.dtype.name) == ("int32", "int64")


def test_helpers():
    from paddle_tpu.nn.layer import HookRemoveHelper as JHelper
    from paddle_tpu_torch.nn.layer import HookRemoveHelper
    from paddle_tpu_torch.ops import op_registry
    from paddle_tpu_torch.vision.models import resnet
    for cls in (JHelper, HookRemoveHelper):
        hooks = {3: print}
        cls(hooks, 3).remove()
        assert hooks == {}
        cls(hooks, 3).remove()
    before = op_registry.dispatch_counts().get("sinc", 0)
    tpaddle.sinc(tpaddle.to_tensor(X))
    tpaddle.sinc(tpaddle.to_tensor(X))
    assert op_registry.dispatch_counts()["sinc"] == before + 2
    assert callable(resnet.load_pretrained)
    assert resnet.load_pretrained.__module__ == \
        "paddle_tpu_torch.vision.models.resnet"


def test_is_grad_enabled_and_cast_rows():
    from paddle_tpu_torch.ops import op_registry
    assert op_registry.resolve("is_grad_enabled")() is True
    with tpaddle.no_grad():
        assert tpaddle.nn.functional.is_grad_enabled() is False
    out = op_registry.resolve("cast")(tpaddle.to_tensor(X), "int32")
    np.testing.assert_array_equal(_np(out), _np(jpaddle.cast(
        jpaddle.to_tensor(X), "int32")))
