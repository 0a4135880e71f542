"""The port's gradient clipping against the JAX package's, on the CPU.

The same gradients (numpy, seeded) go through each JAX clip class and
the port's, and through both ``clip_grad_norm_``. Tolerances: f32
within 1e-6 relative (the two frameworks sum the norms in other
orders); bf16 within one bf16 rounding (2^-8 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.utils import clip_grad as jclip
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.utils import clip_grad as tclip

SHAPES = [(6, 5), (7,), (1,), (3, 2, 4)]
TOL = {"float32": dict(rtol=1e-6, atol=1e-9),
       "bfloat16": dict(rtol=2.0 ** -8, atol=0)}


def _grads(dtype, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    gs = [(scale * rng.standard_normal(s)).astype(np.float32)
          for s in SHAPES]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jgs = [jnp.asarray(g, jd) for g in gs]
    tgs = [torch.from_numpy(g).to(getattr(torch, dtype)) for g in gs]
    return jgs, tgs


def _np(x):
    return np.asarray(getattr(x, "_data", x), np.float32) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


CLIPS = [("global_norm-1", lambda m: m.ClipGradByGlobalNorm(1.0)),
         ("global_norm-100", lambda m: m.ClipGradByGlobalNorm(100.0)),
         ("norm-0.5", lambda m: m.ClipGradByNorm(0.5)),
         ("value-0.3", lambda m: m.ClipGradByValue(0.3)),
         ("value-asym", lambda m: m.ClipGradByValue(0.2, min=-0.1))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("build", [b for _, b in CLIPS],
                         ids=[i for i, _ in CLIPS])
def test_clip_classes_match_jax(build, dtype):
    jgs, tgs = _grads(dtype, scale=0.7)
    jps = [JParameter(jnp.zeros(s)) for s in SHAPES]
    tps = [torch.zeros(s) for s in SHAPES]
    want = build(paddle.nn)([(p, JTensor(g)) for p, g in zip(jps, jgs)])
    got = build(tnn)(list(zip(tps, tgs)))
    for (jp, jg), (tp, tg), p0 in zip(want, got, tps):
        assert tp is p0
        assert tg.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(tg), _np(jg), **TOL[dtype])


def test_none_grads_keep_their_slots():
    _, tgs = _grads("float32")
    pg = [(torch.zeros(1), None), (torch.zeros(SHAPES[0]), tgs[0])]
    out = tnn.ClipGradByGlobalNorm(0.1)(pg)
    assert out[0][1] is None and out[1][1].shape == SHAPES[0]
    assert tnn.ClipGradByGlobalNorm(0.1)([(torch.zeros(1), None)])[0][1] \
        is None


def test_clip_spec_matches_only_the_exact_classes():
    class MyClip(tnn.ClipGradByGlobalNorm):
        pass

    assert tclip.clip_spec(None) == ()
    assert tclip.clip_spec(tnn.ClipGradByGlobalNorm(2)) == \
        ("global_norm", 2.0)
    assert tclip.clip_spec(tnn.ClipGradByNorm(0.5)) == ("norm", 0.5)
    assert tclip.clip_spec(tnn.ClipGradByValue(0.3)) == \
        ("value", -0.3, 0.3)
    assert tclip.clip_spec(MyClip(2)) is None
    assert tclip.clip_spec(MyClip(2), exact=False) == ("global_norm", 2.0)
    for _, build in CLIPS:
        assert tclip.clip_spec(build(tnn)) == jclip.clip_spec(
            build(paddle.nn))


def test_non_finite_norm_propagates_as_jax():
    """A non-finite gradient makes the global scale NaN or 0 in both
    packages (NaN-propagating max)."""
    for bad in (float("inf"), float("nan")):
        gs = [np.ones(3, np.float32), np.array([1.0, bad], np.float32)]
        want = jclip.clip_by_spec(("global_norm", 1.0),
                                  [jnp.asarray(g) for g in gs])
        got = tclip.clip_by_spec(("global_norm", 1.0),
                                 [torch.from_numpy(g) for g in gs])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_type", [2.0, float("inf")],
                         ids=["l2", "inf"])
@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "no-clip"])
def test_clip_grad_norm_matches_jax(norm_type, dtype, max_norm):
    jgs, tgs = _grads(dtype, seed=1)
    jps = [JParameter(jnp.zeros(s)) for s in SHAPES]
    tps = [torch.zeros(s, dtype=getattr(torch, dtype), requires_grad=True)
           for s in SHAPES]
    for jp, jg, tp, tg in zip(jps, jgs, tps, tgs):
        jp.grad = JTensor(jg)
        tp.grad = tg
    jtotal = jclip.clip_grad_norm_(jps, max_norm, norm_type)
    ttotal = tclip.clip_grad_norm_(tps, max_norm, norm_type)
    np.testing.assert_allclose(_np(ttotal), _np(jtotal), **TOL[dtype])
    for jp, tp in zip(jps, tps):
        assert tp.grad.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(tp.grad), _np(jp.grad),
                                   **TOL[dtype])
    assert float(tclip.clip_grad_norm_([torch.zeros(2)], 1.0)) == 0.0
