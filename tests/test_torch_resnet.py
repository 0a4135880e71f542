"""The port's ResNet family against the JAX package's, on the CPU, and the
device-lr Momentum / SGD step.

A JAX ``resnet18``'s ``state_dict()`` (running statistics included)
comes across through ``convert.resnet_from_jax``.
At 32×32, batch 4, 10 classes, in both layouts: the logits and the loss
of one training forward, the gradient of every parameter and the
running statistics after it (the JAX side as one jitted
``value_and_grad`` through ``functionalize``): logits and loss within
1e-4 · (1 + |ref|), gradients and statistics within 1e-3 · (1 + |ref|)
and 1e-3 in relative RMS (f32 on both sides, 18 layers of sums in
other orders). Then two ``TrainStep``s with ``Momentum(0.01, 0.9)`` and
``CrossEntropyLoss`` on each side (batch 8), after each: the loss
within 1e-4, every parameter and running statistic within
1e-3 · (1 + |ref|) and 1e-3 in relative RMS, the velocities (sums of
the gradients) within 1e-2 in relative RMS. The closed-form batch-norm
backward both packages compute (``Σg·x − m·Σg``, one pass) cancels in
f32 where a channel's mean is large against its spread, so two f32
implementations part on the early layers' gradients by up to about a
percent (the port on the card against the port on the CPU,
``chip_smoke.py``'s ``resnet_parity``, at 1.3e-2 on its worst tensor),
and the second step inherits the first's parting. At batch 4 this
test's second step parts by more than that, so the steps run at batch
8. A
ResNeXt bottleneck block (groups 4) is held like the single step.

The fused Momentum and SGD step (multi-tensor ops on the device lr
tensor) equals the per-parameter ``_update`` loop bit for bit, f32 and
bf16, Nesterov and L2 decay included, and ``TrainStep`` no longer
counts these optimizers ``"optimizer"``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
from paddle_tpu.jit.api import functionalize
from paddle_tpu_torch.convert import resnet_from_jax
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import fused_step
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
STATE_TOL = 1e-3
LR, MOMENTUM, STEPS = 0.01, 0.9, 2
STEP_BATCH = 8
VEL_RMS = 1e-2


def _rel_rms(got, want, scale):
    return np.sqrt(np.mean((got - want) ** 2)) / max(
        np.sqrt(np.mean(scale ** 2)), 1e-30)


def _close(got, want, what, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol != OUT_TOL and got.size > 1:
        assert _rel_rms(got, want, want) <= tol or not want.any(), what
    err = np.abs(got - want) - tol * (1 + np.abs(want))
    assert (err <= 0).all(), (what, float(np.abs(got - want).max()))


def _data(layout, n=4, size=32, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, 3, size, size)) * 0.5).astype(np.float32)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return x, rng.integers(0, classes, (n,)).astype(np.int64)


@pytest.fixture(scope="module")
def jax_resnet18():
    """A JAX resnet18 per layout and its state dict as numpy. The JAX
    initializers are not what is tested and each compiles its draw per
    shape (~14 s for ResNet-18 on the CPU): the JAX layers are built
    with zeros and given weights drawn with numpy from a seed by the
    port's initializers' laws, running statistics drawn to be
    nontrivial (``torch_reference_weights``)."""
    arrays = None
    out = {}
    zeros = jpaddle.nn.initializer.Constant(0.0)
    make = jpaddle.nn.Layer.create_parameter
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpaddle.nn.Layer, "create_parameter",
                   lambda self, shape, attr=None, dtype=None, is_bias=False,
                   default_initializer=None: make(
                       self, shape, attr, dtype, is_bias, zeros))
        for layout in ("NCHW", "NHWC"):
            jm = jpaddle.vision.models.resnet18(num_classes=10,
                                                data_format=layout)
            if arrays is None:
                arrays = law_arrays({k: v.shape for k, v
                                     in jm.state_dict().items()}, 7)
            jm.set_state_dict(arrays)
            out[layout] = (jm, {k: np.asarray(v._data)
                                for k, v in jm.state_dict().items()})
    return out


def test_resnet_from_jax_carries_every_parameter_and_buffer(jax_resnet18):
    jm, arrays = jax_resnet18["NHWC"]
    tm = resnet_from_jax("resnet18", arrays, num_classes=10,
                         data_format="NHWC")
    tsd = tm.state_dict()
    assert set(tsd) == set(arrays)
    assert any(k.endswith("_mean") for k in tsd)
    for k, v in arrays.items():
        np.testing.assert_array_equal(tsd[k].numpy(), v, err_msg=k)
    conv = tm._modules["conv1"]._parameters["weight"]
    assert conv.is_contiguous(memory_format=torch.channels_last)
    # a bf16 JAX model comes across in bf16, buffers included
    bf = {k: v.astype(jnp.bfloat16) for k, v in arrays.items()}
    tb = resnet_from_jax("resnet18", bf, num_classes=10, data_format="NHWC")
    assert tb.bn1._mean.dtype == torch.bfloat16
    assert tb.conv1.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tb.state_dict()["layer1.0.bn1._variance"].numpy(),
        np.asarray(bf["layer1.0.bn1._variance"], np.float32))


def _jax_forward_backward(jm, x, y):
    ce = jpaddle.nn.CrossEntropyLoss()
    apply, params, buffers = functionalize(
        jm, lambda a, b: (ce(jm(a), b), jm(a)))

    def loss_of(p):
        (loss, logits), new_buf = apply(p, buffers, x, y)
        return loss, (logits, new_buf)

    (loss, (logits, new_buf)), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(params)
    return float(loss), np.asarray(logits), \
        {k: np.asarray(v) for k, v in grads.items()}, \
        {k: np.asarray(v) for k, v in new_buf.items()}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet18_forward_and_gradients_match_jax(jax_resnet18, layout):
    """One training-mode forward and backward against JAX's, the port
    differentiating each ReLU on the piece JAX's program took where
    its own f32 rounding put an element on the other (``torch_kinks``:
    one such element moves batch-norm gradients by several per cent)."""
    jm, arrays = jax_resnet18[layout]
    x, y = _data(layout)
    jm.train()
    slopes, hooks = record_jax_slopes(jm)
    try:
        jloss, jlogits, jgrads, jbuf = _jax_forward_backward(jm, x, y)
    finally:
        for h in hooks:
            h.remove()
    tm = resnet_from_jax("resnet18", arrays, num_classes=10,
                         data_format=layout)
    tm.train()
    flips = []
    unwrap = follow_slopes(tm, slopes, flips)   # the loss's forward first
    logits = tm(tpaddle.to_tensor(x))
    unwrap()
    assert len(flips) == len(slopes) // 2 and sum(flips) <= MAX_FLIPS
    loss = tpaddle.nn.CrossEntropyLoss()(logits, tpaddle.to_tensor(y))
    loss.backward()
    _close(logits.numpy(), jlogits, "logits", OUT_TOL)
    _close(float(loss), jloss, "loss", OUT_TOL)
    params = dict(tm.named_parameters())
    assert set(params) == set(jgrads)
    for k, g in jgrads.items():
        _close(params[k].grad.numpy(), g, k, STATE_TOL)
    # functionalize runs the forward twice (loss and logits): the JAX
    # statistics took two updates from the same batch; take the port's
    # twice too
    tm(tpaddle.to_tensor(x))
    tsd = tm.state_dict()
    for k, v in jbuf.items():
        _close(tsd[k].numpy(), v, k, STATE_TOL)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet18_momentum_train_steps_match_jax(jax_resnet18, layout):
    """Two momentum steps of ``TrainStep`` against JAX's, each port step
    differentiating each ReLU on the piece JAX's captured step took
    where the two differ (``torch_kinks``)."""
    jm, arrays = jax_resnet18[layout]
    jm.set_state_dict(arrays)
    tm = resnet_from_jax("resnet18", arrays, num_classes=10,
                         data_format=layout)
    jopt = jpaddle.optimizer.Momentum(LR, MOMENTUM,
                                      parameters=jm.parameters())
    topt = tpaddle.optimizer.Momentum(LR, MOMENTUM,
                                      parameters=tm.parameters())
    jce, tce = jpaddle.nn.CrossEntropyLoss(), tpaddle.nn.CrossEntropyLoss()
    slopes, hooks = record_jax_slopes(jm)
    jstep = JaxTrainStep(jm, lambda o, lb: jce(o, lb), jopt)
    tstep = TrainStep(tm, tce, topt)
    try:
        for s in range(STEPS):
            x, y = _data(layout, n=STEP_BATCH, seed=10 + s)
            del slopes[:]
            jl = float(jstep(jpaddle.to_tensor(x), jpaddle.to_tensor(y)))
            flips = []
            unwrap = follow_slopes(tm, list(slopes), flips)
            tl = tstep(tpaddle.to_tensor(x), tpaddle.to_tensor(y))
            unwrap()
            assert len(flips) == len(slopes) and sum(flips) <= MAX_FLIPS
            _close(float(tl), jl, f"loss {s}", OUT_TOL)
            tsd = tm.state_dict()
            for k, v in jm.state_dict().items():
                _close(tsd[k].numpy(), np.asarray(v._data), f"{k} step {s}",
                       STATE_TOL)
            jvel = {k: np.asarray(getattr(v, "_data", v))
                    for k, v in jopt.state_dict().items()
                    if k.endswith("_velocity")}
            tvel = {k: v.numpy() for k, v in topt.state_dict().items()
                    if k.endswith("_velocity")}
            assert set(jvel) == set(tvel) and jvel
            for k in jvel:
                assert _rel_rms(tvel[k].astype(np.float64), jvel[k],
                                jvel[k]) <= VEL_RMS, f"{k} step {s}"
    finally:
        for h in hooks:
            h.remove()
    assert tstep.stats["fallbacks"] == {"device": STEPS - 1}


def test_resnext_block_with_groups_matches_jax():
    jpaddle.seed(3)
    kw = dict(groups=4, base_width=32, data_format="NHWC")

    def block(P):
        ds = P.nn.Sequential(
            P.nn.Conv2D(16, 32, 1, stride=2, bias_attr=False,
                        data_format="NHWC"),
            P.nn.BatchNorm2D(32, data_format="NHWC"))
        return P.vision.models.resnet.BottleneckBlock(16, 8, 2, ds, **kw)

    jb, tb = block(jpaddle), block(tpaddle)
    arrays = {k: np.asarray(v._data) for k, v in jb.state_dict().items()}
    tb.set_state_dict(arrays)
    assert tb.conv2.weight.shape == [16, 4, 3, 3]
    x = np.random.default_rng(1).standard_normal((3, 8, 8, 16)).astype(
        np.float32)
    g = np.random.default_rng(2).standard_normal((3, 4, 4, 32)).astype(
        np.float32)
    apply, params, buffers = functionalize(jb)

    def loss_of(p):
        out, _ = apply(p, buffers, x)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_of,
                                                   has_aux=True))(params)
    xt = tpaddle.to_tensor(x)
    out = tb(xt)
    (out * tpaddle.to_tensor(g)).sum().backward()
    _close(out.numpy(), np.asarray(jout), "out", OUT_TOL)
    tparams = dict(tb.named_parameters())
    for k, v in jgrads.items():
        _close(tparams[k].grad.numpy(), np.asarray(v), k, STATE_TOL)


def _params(dtype, seed=0):
    rng = np.random.default_rng(seed)
    ps = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .to(dtype) for s in [(6, 3, 3, 3), (7,), (4, 5)]]
    ps[0] = ps[0].contiguous(memory_format=torch.channels_last)
    return [p.requires_grad_() for p in ps]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cls,kw", [
    ("SGD", {}), ("SGD", {"weight_decay": 0.01}),
    ("Momentum", {}), ("Momentum", {"use_nesterov": True,
                                    "weight_decay": 0.02})],
    ids=["SGD", "SGD-wd", "Momentum", "Momentum-nesterov-wd"])
def test_device_lr_momentum_and_sgd_equal_the_loop(cls, kw, dtype):
    """Four steps under a changing lr, fused and through the loop: the
    parameters and velocities bit for bit; the fused steps counted, lr
    read from the device tensor the step refills."""
    runs = []
    for fused in (True, False):
        set_flags({"FLAGS_fused_optimizer": fused})
        try:
            ps = _params(dtype)
            sched = tpaddle.optimizer.lr.StepDecay(0.1, step_size=2)
            opt = getattr(tpaddle.optimizer, cls)(
                learning_rate=sched, parameters=ps, **kw)
            rng = np.random.default_rng(1)
            before = fused_step._M_steps.total()
            for _ in range(4):
                for p in ps:
                    p.grad = torch.from_numpy(rng.standard_normal(
                        tuple(p.shape)).astype(np.float32)).to(dtype)
                opt.step()
                sched.step()
            assert fused_step._M_steps.total() - before == \
                (4 if fused else 0)
            if fused:
                assert float(opt._fused_lr_dev) == pytest.approx(0.01)
            runs.append((ps, opt._states))
        finally:
            set_flags({"FLAGS_fused_optimizer": True})
    (fps, fst), (lps, lst) = runs
    for a, b in zip(fps, lps):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert fps[0].is_contiguous(memory_format=torch.channels_last)
    for i in lst:
        for k in lst[i]:
            assert torch.equal(fst[i][k], lst[i][k])


def test_momentum_masked_by_a_found_flag_keeps_the_old_values():
    ps = _params(torch.float32)
    opt = tpaddle.optimizer.Momentum(0.1, parameters=ps)
    for p in ps:
        p.grad = torch.ones_like(p)
    old = [p.detach().clone() for p in ps]
    opt._step_masked(torch.tensor(True))
    assert all(torch.equal(p, o) for p, o in zip(ps, old))
    assert all(not s["velocity"].any() for s in opt._states.values())
    opt._step_masked(torch.tensor(False))
    assert not torch.equal(ps[1], old[1])


def test_momentum_under_a_grad_scaler_equals_the_loop():
    """The scaled path (O1's unscale and finite check, then the
    multi-tensor update masked by the flag) against the loop's
    ``unscale_`` + masked step: bit for bit over a finite step and an
    inf step (skipped, the scale halved)."""
    from paddle_tpu_torch.amp import GradScaler
    runs = []
    for fused in (True, False):
        set_flags({"FLAGS_fused_optimizer": fused})
        try:
            ps = _params(torch.float32, seed=3)
            opt = tpaddle.optimizer.Momentum(0.1, 0.9, parameters=ps,
                                             use_nesterov=True)
            sc = GradScaler(init_loss_scaling=8.0,
                            decr_every_n_nan_or_inf=1, device="cpu")
            for poison in (False, True, False):
                for i, p in enumerate(ps):
                    g = torch.full_like(p, 8.0 * (i + 1))
                    if poison and i == 1:
                        g[0] = float("inf")
                    p.grad = g
                sc.step(opt)
                sc.update()
            runs.append(([p.detach().clone() for p in ps],
                         [s["velocity"] for _, s in sorted(
                             opt._states.items())], float(sc._scale)))
        finally:
            set_flags({"FLAGS_fused_optimizer": True})
    (fp, fv, fs), (lp, lv, ls) = runs
    assert fs == ls == 4.0
    assert all(torch.equal(a, b) for a, b in zip(fp, lp))
    assert all(torch.equal(a, b) for a, b in zip(fv, lv))


def test_pretrained_loads_a_local_file_only(tmp_path, monkeypatch):
    """``pretrained=True`` finds the weights file by the URL's file name
    in ``PADDLE_TPU_PRETRAINED_DIR`` and installs it; without the file
    it raises, and nothing is downloaded."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.vision.models import resnet as tresnet
    monkeypatch.setenv("PADDLE_TPU_PRETRAINED_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_WEIGHTS_HOME", str(tmp_path / "home"))
    url = tresnet.model_urls["resnet18"][0]
    monkeypatch.setitem(tresnet.model_urls, "resnet18", (url, None))
    with pytest.raises(FileNotFoundError):
        tpaddle.vision.models.resnet18(pretrained=True)
    tpaddle.seed(5)
    src = tpaddle.vision.models.resnet18()
    framework.io.save(src.state_dict(), str(tmp_path / "resnet18.pdparams"))
    got = tpaddle.vision.models.resnet18(pretrained=True)
    for k, v in src.state_dict().items():
        np.testing.assert_array_equal(got.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)
    with pytest.raises(ValueError):
        tpaddle.vision.models.resnet18(pretrained=True, arch="resnet7")


@pytest.mark.parametrize("name", ["MNIST", "Cifar10", "Flowers"])
def test_synthetic_datasets_and_transforms_equal_jax(name):
    """The numpy copies: the same synthetic samples, and the same
    transformed images from the same Python ``random`` draws."""
    import random
    jset = getattr(jpaddle.vision.datasets, name)(mode="test")
    tset = getattr(tpaddle.vision.datasets, name)(mode="test")
    assert len(jset) == len(tset)
    np.testing.assert_array_equal(tset.images, jset.images)
    np.testing.assert_array_equal(tset.labels, jset.labels)
    outs = []
    for P in (jpaddle, tpaddle):
        T = P.vision.transforms
        tf = T.Compose([T.RandomCrop(24, padding=4),
                        T.RandomHorizontalFlip(), T.ToTensor(),
                        T.Normalize([0.5], [0.5])])
        random.seed(9)
        outs.append(np.stack([tf(tset.images[i]) for i in range(4)]))
    np.testing.assert_array_equal(outs[0], outs[1])
