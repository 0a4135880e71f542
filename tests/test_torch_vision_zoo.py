"""The port's vision model zoo against the JAX package's, on the CPU.

Every family beyond ResNet at a small size: the JAX model is built
with zero parameters (the JAX initializers are not what is tested and
each compiles its draw per shape) and given weights drawn with numpy
from a seed by the port's initializers' laws, running statistics drawn
to be nontrivial (``torch_reference_weights``), and its
``state_dict()`` is carried over to the port through
``convert.vision_from_jax``. The same seeded numpy
images go through both in eval mode (the JAX side jitted through
``functionalize``): logits within 1e-4 · (1 + |ref|) (f32 on both sides,
sums in other orders). MobileNetV2 and ShuffleNetV2 also take one
training forward and backward with ``CrossEntropyLoss``, dropout at p 0
on both sides (the two packages' key streams differ by design): the
loss within 1e-4 · (1 + |ref|), every gradient within 1e-3 · (1 + |ref|)
and 1e-3 in relative RMS, the running statistics after it within
1e-3 · (1 + |ref|) — the gradients against JAX with the batch norms on
their running statistics, and with batch statistics against the port's
float64 run on the same linear pieces (see that test). The zoo's
``__all__`` is the JAX one, and ``pretrained=True`` finds no file and
downloads nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.jit.api import functionalize
from paddle_tpu_torch.convert import vision_from_jax
from test_torch_tensor import port_on_cpu  # noqa: F401
from torch_kinks import MAX_FLIPS, follow_slopes, record_jax_slopes
from torch_reference_weights import law_arrays


@pytest.fixture(autouse=True, scope="module")
def _jax_fusion_off():
    """The JAX side traces with its lazy fusion off: a ``jax.jit`` trace
    with it on leaves state that breaks later traces in the process
    (``test_semi_auto.py``, ``test_pipeline_tied.py``)."""
    prev = jpaddle.get_flags("FLAGS_eager_fusion")
    jpaddle.set_flags({"FLAGS_eager_fusion": False})
    yield
    jpaddle.set_flags(prev)

OUT_TOL = 1e-4
GRAD_TOL = 1e-3
# the f32 port's gradients against its own float64 run on the same
# linear pieces, through ~20 batch norms of 6–48 channels: at most
# 3.6e-5 in relative RMS over seeds 0–15 of both TRAIN models (and
# 0.19 of GRAD_TOL · (1 + |ref|) elementwise)
F64_RMS = 2e-4

# (arch, constructor kwargs, input shape): sizes that keep each file's
# run short and still reach every layer kind (AlexNet's and VGG's
# adaptive pools from 2×2 and 3×3, SqueezeNet's pools on odd sizes,
# DenseNet's and Inception's padded average pools)
ZOO = [
    ("LeNet", dict(num_classes=10), (2, 1, 28, 28)),
    ("alexnet", dict(num_classes=7), (2, 3, 96, 96)),
    ("vgg11", dict(num_classes=0, batch_norm=True), (2, 3, 96, 96)),
    ("vgg13", dict(num_classes=0), (1, 3, 64, 64)),
    ("squeezenet1_0", dict(num_classes=6), (2, 3, 96, 96)),
    ("squeezenet1_1", dict(num_classes=6), (2, 3, 97, 97)),
    ("mobilenet_v1", dict(scale=0.25, num_classes=10), (2, 3, 64, 64)),
    ("mobilenet_v2", dict(scale=0.25, num_classes=10), (2, 3, 64, 64)),
    ("mobilenet_v3_small", dict(scale=0.5, num_classes=10), (2, 3, 64, 64)),
    ("mobilenet_v3_large", dict(scale=0.5, num_classes=10), (2, 3, 64, 64)),
    ("densenet121", dict(num_classes=5), (2, 3, 64, 64)),
    ("shufflenet_v2_x0_25", dict(num_classes=4), (2, 3, 64, 64)),
    ("shufflenet_v2_swish", dict(num_classes=4), (2, 3, 64, 64)),
    ("googlenet", dict(num_classes=9), (2, 3, 96, 96)),
    ("inception_v3", dict(num_classes=8), (2, 3, 75, 75)),
]


def _zero_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                    default_initializer=None):
    if attr is False:
        return None
    return JParameter(jnp.asarray(np.zeros(tuple(shape), np.float32)),
                      stop_gradient=False)


def _pair(arch, kwargs, seed=3):
    """(JAX model, port model) holding the same weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpaddle.nn.Layer, "create_parameter", _zero_parameter)
        jm = getattr(jpaddle.vision.models, arch)(**kwargs)
    arrays = law_arrays({k: v.shape for k, v in jm.state_dict().items()},
                        seed)
    jm.set_state_dict(arrays)
    jarrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    assert set(jarrays) == set(arrays)
    tm = vision_from_jax(arch, jarrays, **kwargs)
    return jm, tm, jarrays


def _close(got, want, what, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) - tol * (1 + np.abs(want))
    assert (err <= 0).all(), (what, float(np.abs(got - want).max()))


def _rel_rms(got, want):
    return np.sqrt(np.mean((got - want) ** 2)) / max(
        np.sqrt(np.mean(want ** 2)), 1e-30)


def _image(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("arch,kwargs,shape", ZOO,
                         ids=[z[0] for z in ZOO])
def test_zoo_eval_logits_match_jax(arch, kwargs, shape):
    jm, tm, arrays = _pair(arch, kwargs)
    tsd = tm.state_dict()
    assert set(tsd) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(tsd[k].numpy(), v, err_msg=k)
    x = _image(shape)
    jm.eval()
    tm.eval()
    apply, params, buffers = functionalize(jm, lambda a: jm(a))
    want = jax.jit(lambda p, b, a: apply(p, b, a)[0])(params, buffers, x)
    got = tm(tpaddle.to_tensor(x))
    if isinstance(want, (tuple, list)):
        # GoogLeNet: (out, aux1, aux2), as the JAX model returns
        assert isinstance(got, tuple) and len(got) == len(want) == 3
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g.numpy(), np.asarray(w), f"{arch} out {i}", OUT_TOL)
    else:
        _close(got.numpy(), np.asarray(want), arch, OUT_TOL)


def _no_dropout(model, dropout_cls):
    for layer in model.sublayers():
        if isinstance(layer, dropout_cls):
            layer.p = 0.0


def _freeze_batch_norms(model):
    for layer in model.sublayers():
        if "BatchNorm" in type(layer).__name__:
            layer.eval()


def _grads_close(got, want, what, rms=GRAD_TOL):
    """The relative RMS within ``rms`` for each tensor whose reference
    reaches 1e-3 of the model's largest gradient (a batch norm's bias
    that feeds the next batch norm through a convolution has an exact
    gradient of zero, and some scales are that small by structure: their
    relative error is rounding); every element within GRAD_TOL ·
    (1 + |ref|)."""
    assert set(got) == set(want)
    top = max(float(np.abs(g).max()) for g in want.values())
    for k, g in want.items():
        _close(got[k], g, f"{what} {k}", GRAD_TOL)
        if np.abs(g).max() >= 1e-3 * top:
            assert _rel_rms(got[k], g) <= rms, (what, k,
                                               _rel_rms(got[k], g))


TRAIN = [("mobilenet_v2", dict(scale=0.25, num_classes=10)),
         ("shufflenet_v2_x0_25", dict(num_classes=10))]

def _train_pair(arch, kwargs, frozen):
    jm, tm, arrays = _pair(arch, kwargs, seed=5)
    _no_dropout(jm, jpaddle.nn.Dropout)
    _no_dropout(tm, tpaddle.nn.Dropout)
    jm.train()
    tm.train()
    if frozen:
        _freeze_batch_norms(jm)
        _freeze_batch_norms(tm)
    x = _image((8, 3, 64, 64), seed=1)
    y = np.random.default_rng(2).integers(0, 10, (8,)).astype(np.int64)
    ce = jpaddle.nn.CrossEntropyLoss()
    slopes, hooks = record_jax_slopes(jm)
    apply, params, buffers = functionalize(jm, lambda a, b: ce(jm(a), b))
    (jloss, jbuf), jgrads = jax.jit(jax.value_and_grad(
        lambda p: apply(p, buffers, x, y), has_aux=True))(params)
    for h in hooks:
        h.remove()
    flips = []
    unwrap = follow_slopes(tm, slopes, flips)
    loss = tpaddle.nn.CrossEntropyLoss()(tm(tpaddle.to_tensor(x)),
                                         tpaddle.to_tensor(y))
    unwrap()
    assert len(flips) == len(slopes) and sum(flips) <= MAX_FLIPS, flips
    loss.backward()
    _close(float(loss), float(jloss), f"{arch} loss", OUT_TOL)
    grads = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    return tm, arrays, (x, y), grads, jgrads, jbuf, slopes


@pytest.mark.parametrize("arch,kwargs", TRAIN, ids=[t[0] for t in TRAIN])
def test_train_backward_with_frozen_statistics_matches_jax(arch, kwargs):
    """Training mode with the batch norms on their running statistics:
    every backward of the network but batch norm's batch-statistics one
    (convolutions, depthwise convolutions, the channel split, concat and
    shuffle, the activations, pooling, the classifier) against JAX, the
    port taking the ReLU pieces JAX's program took where its own
    differ (``torch_kinks``)."""
    *_, grads, jgrads, _, _ = _train_pair(arch, kwargs, frozen=True)
    _grads_close(grads, {k: np.asarray(v) for k, v in jgrads.items()},
                 arch)


@pytest.mark.parametrize("arch,kwargs", TRAIN, ids=[t[0] for t in TRAIN])
def test_train_forward_backward_matches_jax(arch, kwargs):
    """Full training mode: the loss and the running statistics against
    JAX; the gradients against the same port model run in float64 on
    the same linear pieces (``torch_kinks``). An activation input within
    rounding of a ReLU's or ReLU6's kink can fall on the other piece in
    another precision; one such element, at a 2×2 stage with 8 images,
    moves batch-norm gradients upstream by ~10 % (ShuffleNetV2 x0.25 at
    3 of 16 seeds, one or two elements at |x| ~1e-6). So both port runs
    take the pieces JAX's program took where their own differ (at most
    MAX_FLIPS each), and what is left is rounding: F64_RMS in relative
    RMS, GRAD_TOL · (1 + |ref|) elementwise. The JAX package's f32
    gradients are not the reference here; the frozen-statistics test
    above holds every other backward against them."""
    import torch
    tm, arrays, (x, y), grads, _, jbuf, slopes = _train_pair(
        arch, kwargs, frozen=False)
    tsd = tm.state_dict()
    for k, v in jbuf.items():
        _close(tsd[k].numpy(), np.asarray(v), k, GRAD_TOL)
    t64 = vision_from_jax(arch, arrays, **kwargs).double()
    _no_dropout(t64, tpaddle.nn.Dropout)
    t64.train()
    flips = []
    unwrap = follow_slopes(t64, slopes, flips)
    torch.nn.functional.cross_entropy(
        t64(torch.from_numpy(x).double()), torch.from_numpy(y)).backward()
    unwrap()
    assert len(flips) == len(slopes) and sum(flips) <= MAX_FLIPS, flips
    _grads_close(grads, {k: p.grad.numpy()
                         for k, p in t64.named_parameters()}, arch,
                 rms=F64_RMS)


def test_zoo_all_is_the_jax_all():
    assert tpaddle.vision.models.__all__ == jpaddle.vision.models.__all__
    for name in tpaddle.vision.models.__all__:
        assert callable(getattr(tpaddle.vision.models, name)), name


def test_pretrained_reads_local_files_only(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PRETRAINED_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_WEIGHTS_HOME", str(tmp_path))
    M = tpaddle.vision.models
    with pytest.raises(FileNotFoundError, match="does not download"):
        M.squeezenet1_1(pretrained=True)
    # weights are published at scale 1.0 only, and for no VGG with
    # batch norm: those fail before any file is looked for
    with pytest.raises(ValueError, match="no published pretrained"):
        M.mobilenet_v2(pretrained=True, scale=0.5)
    with pytest.raises(ValueError, match="no published pretrained"):
        M.vgg11(pretrained=True, batch_norm=True)
