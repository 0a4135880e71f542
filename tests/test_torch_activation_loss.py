"""The port's activation and loss functionals and Layers against the JAX
package's, on the CPU.

Every ported row runs on the same f32 inputs (numpy, seeded) on both
sides: the output, and the gradient of ``sum(out * w)`` (``w`` a fixed
random weighting) with respect to the float inputs, within
1e-5 · (1 + |ref|). The random rows (``gumbel_softmax``, ``rrelu`` in
training) draw from the port's generator, so they are held to their
laws. Each Layer matches its JAX Layer. ``op_registry.unported()`` no
longer lists the rows this slice ports.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.ops import op_registry
from test_torch_tensor import port_on_cpu  # noqa: F401

TOL = 1e-5

_R = np.random.default_rng(7)


def _f(*shape, scale=1.0, shift=0.0):
    return (_R.standard_normal(shape) * scale + shift).astype(np.float32)


def _u(*shape, lo=0.05, hi=0.95):
    return _R.uniform(lo, hi, shape).astype(np.float32)


def _i(*shape, hi=5):
    return _R.integers(0, hi, shape).astype(np.int64)


def _pm(*shape):
    return np.where(_R.standard_normal(shape) > 0, 1.0, -1.0).astype(
        np.float32)


X = _f(3, 5, scale=2.0)
# (id, function of (package, *tensors), numpy inputs)
ACT = [
    ("relu", lambda P, x: P.nn.functional.relu(x), [X]),
    ("relu6", lambda P, x: P.nn.functional.relu6(x), [X * 4]),
    ("leaky_relu", lambda P, x: P.nn.functional.leaky_relu(x, 0.1), [X]),
    ("prelu_1", lambda P, x, w: P.nn.functional.prelu(x, w),
     [X, np.float32([0.3])]),
    ("prelu_c", lambda P, x, w: P.nn.functional.prelu(x, w),
     [X, _f(5)]),
    ("elu", lambda P, x: P.nn.functional.elu(x, 0.7), [X]),
    ("selu", lambda P, x: P.nn.functional.selu(x), [X]),
    ("celu", lambda P, x: P.nn.functional.celu(x, 1.3), [X]),
    ("gelu", lambda P, x: P.nn.functional.gelu(x), [X]),
    ("gelu_tanh", lambda P, x: P.nn.functional.gelu(x, True), [X]),
    ("silu", lambda P, x: P.nn.functional.silu(x), [X]),
    ("swish", lambda P, x: P.nn.functional.swish(x), [X]),
    ("mish", lambda P, x: P.nn.functional.mish(x), [X]),
    ("hardswish", lambda P, x: P.nn.functional.hardswish(x), [X * 2]),
    ("hardsigmoid", lambda P, x: P.nn.functional.hardsigmoid(x), [X * 2]),
    ("hardtanh", lambda P, x: P.nn.functional.hardtanh(x, -0.5, 0.8), [X]),
    ("hardshrink", lambda P, x: P.nn.functional.hardshrink(x, 0.6), [X]),
    ("softshrink", lambda P, x: P.nn.functional.softshrink(x, 0.6), [X]),
    ("tanhshrink", lambda P, x: P.nn.functional.tanhshrink(x), [X]),
    ("thresholded_relu",
     lambda P, x: P.nn.functional.thresholded_relu(x, 0.5), [X]),
    ("softplus", lambda P, x: P.nn.functional.softplus(x, 2.0, 3.0), [X]),
    ("softsign", lambda P, x: P.nn.functional.softsign(x), [X]),
    ("sigmoid", lambda P, x: P.nn.functional.sigmoid(x), [X]),
    ("log_sigmoid", lambda P, x: P.nn.functional.log_sigmoid(x), [X]),
    ("tanh", lambda P, x: P.nn.functional.tanh(x), [X]),
    ("softmax", lambda P, x: P.nn.functional.softmax(x), [X]),
    ("softmax_ax0", lambda P, x: P.nn.functional.softmax(x, axis=0), [X]),
    ("log_softmax", lambda P, x: P.nn.functional.log_softmax(x), [X]),
    ("maxout", lambda P, x: P.nn.functional.maxout(x, 2, axis=1),
     [_f(2, 6, 3)]),
    ("glu", lambda P, x: P.nn.functional.glu(x), [_f(3, 6)]),
    ("rrelu_eval", lambda P, x: P.nn.functional.rrelu(x, training=False),
     [X]),
]

F1, F2 = _f(4, 5), _f(4, 5)
LOGP = np.log(np.exp(F1) / np.exp(F1).sum(1, keepdims=True)).astype(
    np.float32)
LBL = _i(4)
LBL_IGN = LBL.copy()
LBL_IGN[1] = -100
LOSS = [
    ("mse_mean", lambda P, a, b: P.nn.functional.mse_loss(a, b), [F1, F2]),
    ("mse_sum", lambda P, a, b: P.nn.functional.mse_loss(a, b, "sum"),
     [F1, F2]),
    ("mse_none", lambda P, a, b: P.nn.functional.mse_loss(a, b, "none"),
     [F1, F2]),
    ("l1", lambda P, a, b: P.nn.functional.l1_loss(a, b), [F1, F2]),
    ("smooth_l1", lambda P, a, b: P.nn.functional.smooth_l1_loss(
        a, b, delta=0.5), [F1, F2]),
    ("nll", lambda P, a, b: P.nn.functional.nll_loss(a, b), [LOGP, LBL]),
    ("nll_ignore", lambda P, a, b: P.nn.functional.nll_loss(a, b),
     [LOGP, LBL_IGN]),
    ("nll_weight", lambda P, a, b, w: P.nn.functional.nll_loss(
        a, b, weight=w), [LOGP, LBL, _u(5)]),
    ("nll_sum", lambda P, a, b: P.nn.functional.nll_loss(
        a, b, reduction="sum"), [LOGP, LBL]),
    ("bce", lambda P, p, y: P.nn.functional.binary_cross_entropy(p, y),
     [_u(4, 3), _u(4, 3)]),
    ("bce_weight", lambda P, p, y, w: P.nn.functional.binary_cross_entropy(
        p, y, weight=w), [_u(4, 3), _u(4, 3), _u(4, 3)]),
    ("bce_logits", lambda P, z, y:
     P.nn.functional.binary_cross_entropy_with_logits(z, y),
     [_f(4, 3, scale=3), _u(4, 3)]),
    ("bce_logits_pos", lambda P, z, y, pw:
     P.nn.functional.binary_cross_entropy_with_logits(z, y, pos_weight=pw),
     [_f(4, 3, scale=3), _u(4, 3), _u(3, lo=0.5, hi=2.0)]),
    ("kl_div", lambda P, a, b: P.nn.functional.kl_div(a, b),
     [LOGP, _u(4, 5)]),
    ("kl_div_batchmean", lambda P, a, b: P.nn.functional.kl_div(
        a, b, "batchmean"), [LOGP, _u(4, 5)]),
    ("kl_div_log_target", lambda P, a, b: P.nn.functional.kl_div(
        a, b, "sum", log_target=True), [LOGP, LOGP[::-1].copy()]),
    ("hinge_embedding", lambda P, a, y:
     P.nn.functional.hinge_embedding_loss(a, y, 0.5), [F1, _pm(4, 5)]),
    ("margin_ranking", lambda P, a, b, y:
     P.nn.functional.margin_ranking_loss(a, b, y, 0.2), [F1, F2,
                                                         _pm(4, 5)]),
    ("cosine_embedding", lambda P, a, b, y:
     P.nn.functional.cosine_embedding_loss(a, b, y, 0.1),
     [F1, F2, _pm(4)]),
    ("triplet_margin", lambda P, a, p, n:
     P.nn.functional.triplet_margin_loss(a, p, n), [F1, F2, _f(4, 5)]),
    ("triplet_margin_swap", lambda P, a, p, n:
     P.nn.functional.triplet_margin_loss(a, p, n, p=1.0, swap=True),
     [F1, F2, _f(4, 5)]),
    ("ctc", lambda P, lp, lb, il, ll: P.nn.functional.ctc_loss(
        lp, lb, il, ll), [_f(6, 2, 4), np.int64([[1, 2, 0], [3, 3, 1]]),
                          np.int64([6, 5]), np.int64([3, 2])]),
    ("ctc_sum", lambda P, lp, lb, il, ll: P.nn.functional.ctc_loss(
        lp, lb, il, ll, reduction="sum"),
     [_f(6, 2, 4), np.int64([[1, 2, 0], [3, 3, 1]]), np.int64([6, 5]),
      np.int64([3, 2])]),
    ("soft_margin", lambda P, a, y: P.nn.functional.soft_margin_loss(a, y),
     [F1, _pm(4, 5)]),
    ("multi_label_soft_margin", lambda P, a, y, w:
     P.nn.functional.multi_label_soft_margin_loss(a, y, weight=w),
     [F1, (_u(4, 5) > 0.5).astype(np.float32), _u(5)]),
    ("multi_margin", lambda P, a, y: P.nn.functional.multi_margin_loss(
        a, y), [F1, LBL]),
    ("multi_margin_p2_w", lambda P, a, y, w:
     P.nn.functional.multi_margin_loss(a, y, p=2, margin=0.5, weight=w),
     [F1, LBL, _u(5)]),
    ("poisson_nll", lambda P, a, y: P.nn.functional.poisson_nll_loss(a, y),
     [F1, _u(4, 5, lo=0.0, hi=3.0)]),
    ("poisson_nll_full", lambda P, a, y: P.nn.functional.poisson_nll_loss(
        a, y, log_input=False, full=True),
     [_u(4, 5, lo=0.5, hi=2.0), _u(4, 5, lo=0.0, hi=3.0)]),
    ("gaussian_nll", lambda P, a, y, v: P.nn.functional.gaussian_nll_loss(
        a, y, v, full=True), [F1, F2, _u(4, 5)]),
    ("square_error_cost", lambda P, a, b:
     P.nn.functional.square_error_cost(a, b), [F1, F2]),
    ("log_loss", lambda P, a, b: P.nn.functional.log_loss(a, b),
     [_u(4, 1), (_u(4, 1) > 0.5).astype(np.float32)]),
    ("dice", lambda P, a, b: P.nn.functional.dice_loss(a, b),
     [_u(4, 5), _i(4, 1)]),
    ("npair", lambda P, a, p, lb: P.nn.functional.npair_loss(a, p, lb),
     [F1, F2, np.float32([0, 1, 0, 2])]),
    ("sigmoid_focal", lambda P, x, y, n:
     P.nn.functional.sigmoid_focal_loss(x, y, n),
     [F1, (_u(4, 5) > 0.5).astype(np.float32), np.float32([3.0])]),
    ("triplet_distance", lambda P, a, p, n:
     P.nn.functional.triplet_margin_with_distance_loss(a, p, n, swap=True),
     [F1, F2, _f(4, 5)]),
    ("softmax_with_ce", lambda P, a, b:
     P.nn.functional.softmax_with_cross_entropy(a, b), [F1, LBL[:, None]]),
    ("softmax_with_ce_sm", lambda P, a, b:
     P.nn.functional.softmax_with_cross_entropy(a, b, return_softmax=True)[1],
     [F1, LBL[:, None]]),
    ("label_smooth", lambda P, a: P.nn.functional.label_smooth(a),
     [_u(4, 5)]),
    ("label_smooth_prior", lambda P, a, pr:
     P.nn.functional.label_smooth(a, pr, 0.2), [_u(4, 5), _u(5)]),
    ("one_hot", lambda P, a: P.nn.functional.one_hot(a, 6),
     [np.int64([0, 3, 5, 9, -1])]),
]


def _run(pkg, fn, arrays, w):
    ts = [pkg.to_tensor(a, stop_gradient=a.dtype != np.float32)
          for a in arrays]
    out = fn(pkg, *ts)
    grads = []
    if out.dtype in (torch.float32,) or str(getattr(out, "dtype", "")) \
            in ("float32", "paddle.float32"):
        if not all(t.stop_gradient for t in ts):
            loss = (out * pkg.to_tensor(w[:out.numel()].reshape(
                out.shape))).sum()
            loss.backward()
            # an input the output does not reach differentiably (a
            # float label compared with 1) has a zero gradient in JAX
            # and none in torch: both count as zeros
            grads = [None if t.stop_gradient else
                     np.zeros(a.shape, np.float32) if t.grad is None
                     else np.asarray(t.grad.numpy())
                     for t, a in zip(ts, arrays)]
    return np.asarray(out.numpy()), grads


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) - TOL * (1 + np.abs(want))
    assert (err <= 0).all(), (what, float(np.abs(got - want).max()))


@pytest.mark.parametrize("name,fn,arrays", ACT + LOSS,
                         ids=[c[0] for c in ACT + LOSS])
def test_row_matches_jax_forward_and_gradient(name, fn, arrays):
    w = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    got, ggrads = _run(tpaddle, fn, arrays, w)
    want, jgrads = _run(jpaddle, fn, arrays, w)
    _close(got, want, name)
    assert len(ggrads) == len(jgrads)
    for i, (g, j) in enumerate(zip(ggrads, jgrads)):
        assert (g is None) == (j is None), (name, i)
        if g is not None:
            _close(g, j, f"{name} grad {i}")


def test_gumbel_softmax_and_rrelu_draw_from_the_port_generator():
    x = tpaddle.to_tensor(_f(6, 4))
    d0 = trandom.draws()
    tpaddle.seed(5)
    a = tpaddle.nn.functional.gumbel_softmax(x, 0.5).numpy()
    tpaddle.seed(5)
    b = tpaddle.nn.functional.gumbel_softmax(x, 0.5).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a.sum(-1), 1.0, rtol=1e-5)
    h = tpaddle.nn.functional.gumbel_softmax(x, hard=True).numpy()
    assert set(np.unique(h)) <= {0.0, 1.0} and (h.sum(-1) == 1).all()
    neg = tpaddle.to_tensor(-np.abs(_f(200)) - 0.1)
    r = tpaddle.nn.functional.rrelu(neg, 0.1, 0.3).numpy() / neg.numpy()
    assert (r >= 0.1 - 1e-6).all() and (r <= 0.3 + 1e-6).all()
    assert r.std() > 0.01
    assert trandom.draws() >= d0 + 4


LAYERS = [
    ("ReLU", (), [X]), ("ReLU6", (), [X * 4]), ("LeakyReLU", (0.2,), [X]),
    ("PReLU", (), [X]), ("GELU", (True,), [X]), ("Sigmoid", (), [X]),
    ("Tanh", (), [X]), ("Softmax", (0,), [X]), ("LogSoftmax", (), [X]),
    ("ELU", (), [X]), ("SELU", (), [X]), ("CELU", (), [X]),
    ("Silu", (), [X]), ("Swish", (), [X]), ("Mish", (), [X]),
    ("Hardswish", (), [X]), ("Hardsigmoid", (), [X]),
    ("Hardtanh", (), [X]), ("Hardshrink", (), [X]),
    ("Softshrink", (), [X]), ("Tanhshrink", (), [X]),
    ("ThresholdedReLU", (), [X]), ("Softplus", (), [X]),
    ("Softsign", (), [X]), ("LogSigmoid", (), [X]),
    ("Maxout", (2,), [_f(2, 6, 3)]), ("GLU", (), [_f(3, 6)]),
    ("MSELoss", (), [F1, F2]), ("L1Loss", (), [F1, F2]),
    ("SmoothL1Loss", (), [F1, F2]), ("NLLLoss", (), [LOGP, LBL]),
    ("BCELoss", (), [_u(4, 3), _u(4, 3)]),
    ("BCEWithLogitsLoss", (), [F1, _u(4, 5)]),
    ("KLDivLoss", ("batchmean",), [LOGP, _u(4, 5)]),
    ("MarginRankingLoss", (0.1,), [F1, F2, _pm(4, 5)]),
    ("CosineEmbeddingLoss", (), [F1, F2, _pm(4)]),
    ("TripletMarginLoss", (), [F1, F2, _f(4, 5)]),
    ("HingeEmbeddingLoss", (), [F1, _pm(4, 5)]),
    ("CTCLoss", (), [_f(6, 2, 4), np.int64([[1, 2, 0], [3, 3, 1]]),
                     np.int64([6, 5]), np.int64([3, 2])]),
    ("SoftMarginLoss", (), [F1, _pm(4, 5)]),
    ("MultiLabelSoftMarginLoss", (), [F1, (_u(4, 5) > 0.5).astype(
        np.float32)]),
    ("MultiMarginLoss", (), [F1, LBL]),
    ("PoissonNLLLoss", (), [F1, _u(4, 5)]),
    ("GaussianNLLLoss", (), [F1, F2, _u(4, 5)]),
]


@pytest.mark.parametrize("cls,args,arrays", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_matches_jax(cls, args, arrays):
    outs = []
    for pkg in (tpaddle, jpaddle):
        layer = getattr(pkg.nn, cls)(*args)
        outs.append(np.asarray(layer(*[pkg.to_tensor(a)
                                       for a in arrays]).numpy()))
    _close(outs[0], outs[1], cls)


# the rows of ops.yaml this slice ports (unported() listed 95 before it)
PORTED_ROWS = {
    "relu", "relu6", "leaky_relu", "prelu", "elu", "selu", "celu", "silu",
    "swish", "mish", "hardswish", "hardsigmoid", "hardtanh", "hardshrink",
    "softshrink", "tanhshrink", "thresholded_relu", "softplus", "softsign",
    "sigmoid", "log_sigmoid", "softmax", "log_softmax", "gumbel_softmax",
    "maxout", "glu", "rrelu", "mse_loss", "l1_loss", "smooth_l1_loss",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "kl_div", "hinge_embedding_loss", "margin_ranking_loss",
    "cosine_embedding_loss", "triplet_margin_loss", "ctc_loss",
    "soft_margin_loss", "multi_label_soft_margin_loss", "multi_margin_loss",
    "poisson_nll_loss", "gaussian_nll_loss", "softmax_with_cross_entropy",
    "one_hot", "label_smooth",
}


# the rows the vision slice ported after it (conv, pooling, the norms,
# resizing, the vision dropouts): ``tests/test_torch_conv_pool.py``
# pins the list left after both
VISION_ROWS = {
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "max_pool1d", "max_pool2d", "max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
    "adaptive_avg_pool2d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
    "adaptive_max_pool2d", "adaptive_max_pool3d", "batch_norm",
    "group_norm", "instance_norm", "local_response_norm", "interpolate",
    "upsample", "pixel_shuffle", "pixel_unshuffle", "channel_shuffle",
    "fold", "dropout2d", "dropout3d", "alpha_dropout",
}
# the rows the rest of paddle.vision ported (the padding and distance
# functionals the remaining common layers need)
VISION_REST_ROWS = {"pad", "unfold", "bilinear", "cosine_similarity",
                    "normalize"}
# the rows of the op surface's tail (the cast, grad-mode and extra_math
# rows and incubate.nn.functional's fused rows): only ring_attention,
# which goes with the distributed package, is left
TAIL_ROWS = {"cast", "is_grad_enabled", "sinc", "copysign", "deg2rad",
             "rad2deg", "fused_bias_act", "fused_layernorm_residual_dropout",
             "fused_linear", "fused_rms_norm",
             "fused_rotary_position_embedding"}


def test_unported_shrinks_by_exactly_the_ported_rows():
    left = set(op_registry.unported())
    assert not left & (PORTED_ROWS | VISION_ROWS | VISION_REST_ROWS |
                       TAIL_ROWS)
    assert len(left) == 95 - len(PORTED_ROWS) - len(VISION_ROWS) - \
        len(VISION_REST_ROWS) - len(TAIL_ROWS)
    assert left == {"ring_attention"}
    for name in PORTED_ROWS | TAIL_ROWS:
        assert op_registry.resolve(name) is not None, name
