"""The port's random ops on the device key stream, on the CPU.

Each op that used to seed a ``torch.Generator`` from a host draw now
draws from one key of the port's key stream (``core.random``): it
leaves ``draws()`` (the host draws) unchanged and advances the stream
by one key; ``paddle.seed`` and ``get_rng_state`` / ``set_rng_state``
give the same values again. The JAX package's threefry streams differ
from the port's by design, so the laws are compared: each op's sample
statistics at the same size, port against JAX, within 4 standard
errors of their difference. The dropouts' deterministic parts — eval,
``downscale_in_infer``, ``alpha_dropout``'s affine — are held to the
JAX functions' on the same mask (both packages' mask draws patched to
return it). The rejection samplers stay host draws.
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import random as trandom
from test_torch_tensor import port_on_cpu  # noqa: F401

N = 20000
F = tpaddle.nn.functional


def _x(*shape):
    return tpaddle.to_tensor(np.random.default_rng(1).standard_normal(
        shape).astype(np.float32))


# op name -> a call on the port that draws once
MOVED = {
    "rand": lambda: tpaddle.rand([8]),
    "randn": lambda: tpaddle.randn([8]),
    "uniform": lambda: tpaddle.uniform([8]),
    "normal": lambda: tpaddle.normal(shape=[8]),
    "normal_tensor": lambda: tpaddle.normal(_x(8), 1.0),
    "randint": lambda: tpaddle.randint(0, 10, [8]),
    "randperm": lambda: tpaddle.randperm(8),
    "multinomial": lambda: tpaddle.multinomial(tpaddle.ones([2, 5]), 3),
    "multinomial_replace": lambda: tpaddle.multinomial(
        tpaddle.ones([5]), 7, replacement=True),
    "bernoulli": lambda: tpaddle.bernoulli(tpaddle.full([8], 0.3)),
    "standard_normal": lambda: tpaddle.standard_normal([8]),
    "log_normal": lambda: tpaddle.log_normal(shape=[8]),
    "randint_like": lambda: tpaddle.randint_like(_x(8), 0, 5),
    "dropout_axis": lambda: F.dropout(_x(4, 6), 0.5, axis=1),
    "dropout_downscale": lambda: F.dropout(_x(4, 6), 0.5,
                                           mode="downscale_in_infer"),
    "dropout2d": lambda: F.dropout2d(_x(2, 3, 4, 4), 0.5),
    "dropout3d": lambda: F.dropout3d(_x(2, 3, 2, 2, 2), 0.5),
    "alpha_dropout": lambda: F.alpha_dropout(_x(4, 6), 0.5),
    "feature_alpha_dropout": lambda: F.feature_alpha_dropout(
        _x(2, 3, 4), 0.5),
    "gumbel_softmax": lambda: F.gumbel_softmax(_x(4, 6)),
    "rrelu": lambda: F.rrelu(_x(4, 6)),
    "normal_": lambda: _x(8).normal_(),
    "uniform_": lambda: _x(8).uniform_(),
    "exponential_": lambda: _x(8).exponential_(),
    "bernoulli_": lambda: _x(8).bernoulli_(0.3),
    "cauchy_": lambda: _x(8).cauchy_(),
    "geometric_": lambda: _x(8).geometric_(0.3),
    "log_normal_": lambda: _x(8).log_normal_(),
    "svd_lowrank": lambda: tpaddle.linalg.svd_lowrank(_x(6, 5), q=2,
                                                      niter=0),
    "Normal": lambda: tpaddle.nn.initializer.Normal()([4, 4], "float32"),
    "TruncatedNormal": lambda: tpaddle.nn.initializer.TruncatedNormal()(
        [4, 4], "float32"),
    "Uniform": lambda: tpaddle.nn.initializer.Uniform()([4, 4], "float32"),
    "KaimingUniform": lambda: tpaddle.nn.initializer.KaimingUniform()(
        [4, 4], "float32"),
    "XavierNormal": lambda: tpaddle.nn.initializer.XavierNormal()(
        [4, 4], "float32"),
}


def _val(out):
    out = out[0] if isinstance(out, tuple) else out
    return np.asarray(getattr(out, "_t", out).detach().cpu().numpy())


@pytest.mark.parametrize("name", sorted(MOVED))
def test_each_op_takes_one_key_and_no_host_draw(name):
    tpaddle.seed(11)
    d0 = trandom.draws()
    a = _val(MOVED[name]())
    assert trandom.draws() == d0, name
    assert trandom.get_rng_state() == (11, 1), name
    tpaddle.seed(11)
    np.testing.assert_array_equal(_val(MOVED[name]()), a, err_msg=name)
    # the stream replays from a saved state, and moves on after it
    state = trandom.get_rng_state()
    b = _val(MOVED[name]())
    trandom.set_rng_state(state)
    np.testing.assert_array_equal(_val(MOVED[name]()), b, err_msg=name)
    if name not in ("randperm", "multinomial"):
        assert not np.array_equal(a, b), name


def test_rejection_samplers_and_host_structure_stay_host_draws():
    d0 = trandom.draws()
    tpaddle.poisson(tpaddle.ones([4]))
    tpaddle.standard_gamma(tpaddle.ones([4]))
    tpaddle.binomial(tpaddle.full([4], 5, "int64"), tpaddle.full([4], 0.5))
    F.fractional_max_pool2d(_x(1, 2, 9, 9), 4)
    assert trandom.draws() == d0 + 4


def test_the_bits_of_a_key_are_a_function_of_the_key_alone():
    key = torch.tensor([0x12345678, 0x9ABCDEF0], dtype=torch.int64)
    a = trandom.bits((3, 5), key=key)
    assert a.dtype == torch.int64 and a.shape == (3, 5)
    assert int(a.min()) >= 0 and int(a.max()) < 2 ** 32
    np.testing.assert_array_equal(a.numpy(),
                                  trandom.bits((15,), key=key).numpy()
                                  .reshape(3, 5))
    # distinct indices give distinct words (a bijection of the index)
    assert len(np.unique(trandom.bits((4096,), key=key).numpy())) == 4096
    # a chunked draw equals the one-piece draw
    chunk = trandom._CHUNK
    trandom._CHUNK = 7
    try:
        np.testing.assert_array_equal(
            trandom.bits((50,), key=key).numpy(),
            trandom._index_bits(key, 0, 50).numpy())
        np.testing.assert_array_equal(trandom.bits((50,), key=key).numpy()
                                      [:15], a.numpy().reshape(-1))
    finally:
        trandom._CHUNK = chunk


def _reference_bits(w0, w1, start, n):
    """The module docstring's hash in numpy uint32 arithmetic."""
    def fmix(h):
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))
    i = np.arange(start, start + n, dtype=np.uint64).astype(np.uint32)
    a = fmix(i * np.uint32(0x9E3779B1) + np.uint32(w0))
    return fmix((a ^ np.uint32(w1)) * np.uint32(0x85EBCA77))


@pytest.mark.parametrize("start", [0, (1 << 31) - 40])
def test_the_bits_are_the_documented_hash(start):
    w = (0xDEADBEEF, 0x0BADF00D)
    key = torch.tensor(w, dtype=torch.int64)
    got = trandom._index_bits(key, start, 80).numpy()
    np.testing.assert_array_equal(got, _reference_bits(*w, start, 80))
    u = trandom.uniform((80,), key=key).numpy()
    np.testing.assert_array_equal(
        u, (_reference_bits(*w, 0, 80) >> 8).astype(np.float32) * 2 ** -24)


def _jnp(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x, np.float64)


def _tnp(x):
    return np.asarray(getattr(x, "_t", x).double().numpy())


def _within(a, b, stat, se_of):
    """``stat`` of the two samples within 4 standard errors."""
    sa, sb = stat(a), stat(b)
    se = np.sqrt(se_of(a) ** 2 + se_of(b) ** 2)
    assert abs(sa - sb) <= 4 * se, (sa, sb, se)


def _mean_and_var(a, b):
    _within(a, b, np.mean, lambda s: s.std() / np.sqrt(s.size))
    # var's standard error from the fourth central moment
    _within(a, b, np.var, lambda s: np.sqrt(
        (np.mean((s - s.mean()) ** 4) - s.var() ** 2) / s.size))


LAWS = {
    "rand": lambda P: P.rand([N]),
    "randn": lambda P: P.randn([N]),
    "uniform": lambda P: P.uniform([N], min=-2.0, max=3.0),
    "normal": lambda P: P.normal(1.5, 2.0, shape=[N]),
    "standard_normal": lambda P: P.standard_normal([N]),
    "randint": lambda P: P.randint(-3, 7, [N]),
    "bernoulli": lambda P: P.bernoulli(P.full([N], 0.3)),
}


@pytest.mark.parametrize("name", sorted(LAWS))
def test_laws_match_the_jax_ops(name):
    jpaddle.seed(3)
    tpaddle.seed(3)
    a, b = _jnp(LAWS[name](jpaddle)), _tnp(LAWS[name](tpaddle))
    assert a.shape == b.shape == (N,)
    _mean_and_var(a, b)
    if name in ("rand", "uniform", "randint"):
        assert a.min() >= b.min() - 1 and b.max() <= a.max() + 1


def test_permutation_and_categories_match_the_jax_ops():
    jpaddle.seed(3)
    tpaddle.seed(3)
    p = _tnp(tpaddle.randperm(1000)).astype(int)
    assert sorted(p) == list(range(1000))
    # each position's value is uniform: the first positions' mean
    firsts = np.array([_tnp(tpaddle.randperm(10))[0] for _ in range(200)])
    jfirsts = np.array([_jnp(jpaddle.randperm(10))[0] for _ in range(200)])
    _within(firsts, jfirsts, np.mean, lambda s: s.std() / np.sqrt(s.size))
    w = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    t = _tnp(tpaddle.multinomial(tpaddle.to_tensor(w), N,
                                 replacement=True)).astype(int)
    j = _jnp(jpaddle.multinomial(jpaddle.to_tensor(w), N,
                                 replacement=True)).astype(int)
    assert (t != 1).all() and (j != 1).all()
    for c in (0, 2, 3):
        _within((t == c).astype(float), (j == c).astype(float), np.mean,
                lambda s: s.std() / np.sqrt(s.size))
    # without replacement: each row's draws are distinct categories
    rows = _tnp(tpaddle.multinomial(tpaddle.ones([50, 6]), 6)).astype(int)
    assert all(sorted(r) == list(range(6)) for r in rows)


def test_dropout_keep_shares_and_moments_match_jax():
    x = np.ones((N,), np.float32)
    jpaddle.seed(3)
    tpaddle.seed(3)
    for kw in ({"mode": "downscale_in_infer"}, {"axis": 0}):
        a = _jnp(jpaddle.nn.functional.dropout(jpaddle.to_tensor(x), 0.25,
                                               **kw))
        b = _tnp(F.dropout(tpaddle.to_tensor(x), 0.25, **kw))
        _within((a != 0).astype(float), (b != 0).astype(float), np.mean,
                lambda s: s.std() / np.sqrt(s.size))
    z = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    a = _jnp(jpaddle.nn.functional.alpha_dropout(jpaddle.to_tensor(z), 0.2))
    b = _tnp(F.alpha_dropout(tpaddle.to_tensor(z), 0.2))
    _mean_and_var(a, b)


def _same_mask(monkeypatch, mask):
    """Both packages' Bernoulli draws return ``mask`` (broadcast to the
    shape asked for)."""
    def jax_bernoulli(key, p, shape=None):
        return jax.numpy.broadcast_to(jax.numpy.asarray(mask), shape)

    def port_keep(shape, keep_prob, device=None, key=None):
        return torch.as_tensor(mask).expand(tuple(shape)).clone()
    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(trandom, "keep_mask", port_keep)


@pytest.mark.parametrize("fn,kw,shape,mshape", [
    ("dropout", {"p": 0.3, "mode": "downscale_in_infer"}, (4, 6), (4, 6)),
    ("dropout", {"p": 0.3, "axis": 1}, (4, 6), (1, 6)),
    ("dropout", {"p": 0.3, "axis": 1, "mode": "downscale_in_infer"},
     (4, 6), (1, 6)),
    ("alpha_dropout", {"p": 0.3}, (4, 6), (4, 6)),
    ("feature_alpha_dropout", {"p": 0.3}, (2, 3, 4), (2, 3, 1)),
])
def test_dropouts_equal_jax_on_the_same_mask(monkeypatch, fn, kw, shape,
                                             mshape):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    mask = rng.random(mshape) < 0.7
    _same_mask(monkeypatch, mask)
    want = _jnp(getattr(jpaddle.nn.functional, fn)(jpaddle.to_tensor(x),
                                                   **kw))
    got = _tnp(getattr(F, fn)(tpaddle.to_tensor(x), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_eval_equals_jax(mode):
    x = np.random.default_rng(6).standard_normal((4, 6)).astype(np.float32)
    want = _jnp(jpaddle.nn.functional.dropout(
        jpaddle.to_tensor(x), 0.3, training=False, mode=mode))
    got = _tnp(F.dropout(tpaddle.to_tensor(x), 0.3, training=False,
                         mode=mode))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
