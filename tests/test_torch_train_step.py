"""The port's ``jit.TrainStep`` against the JAX package's, on the CPU.

Both are thin wrappers over their package's ``CapturedStep`` in
non-strict mode with ``cast_loss_f32``. On the CPU the port's engine
captures nothing: the first call of a signature runs eager and the
later ones fall back with ``"device"`` (SGD's and AdamW's steps alike:
both update on the device lr), counted; the eager step is the
one the card would capture. Its losses and weights are held to the JAX
step's from the same weights (copied with ``convert``): a linear model
as ``tests/test_sot_capture.py``'s ``TrainStepWrapper`` trains it, a
2-layer Llama and a 2-layer BERT without dropout. Also: a parameter the
loss does not reach is decayed as the JAX step decays it, the loss
comes back in f32, the kill switch does not apply, and a plain
``torch.nn.Module`` with torch tensors goes through the engine.
Tolerances are the training slice's f32 ones
(``tests/test_torch_train.py``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.convert import linear_weight_names, load_from_jax
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import AdamW
from test_torch_tensor import port_on_cpu  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _jax_fusion_off():
    """The JAX side traces with its lazy fusion off: a ``jax.jit`` trace
    with it on leaves state that breaks later traces in the process
    (``test_semi_auto.py``, ``test_pipeline_tied.py``)."""
    prev = jpaddle.get_flags("FLAGS_eager_fusion")
    jpaddle.set_flags({"FLAGS_eager_fusion": False})
    yield
    jpaddle.set_flags(prev)

PKGS = (jpaddle, tpaddle)


def _copy_params(jnet, tnet):
    """The JAX layer's parameters into the port's (same names, same
    paddle layouts)."""
    raw = dict(torch.nn.Module.named_parameters(tnet))
    with torch.no_grad():
        for name, p in jnet.named_parameters():
            raw[name].copy_(torch.from_numpy(np.array(p._data)))


def _mse(o, t):
    return ((o - t) ** 2).mean()


def _xy():
    x = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    return x, (x @ np.ones((4, 1), np.float32) * 0.5).astype(np.float32)


@pytest.mark.parametrize("opt,lr,fallbacks", [
    ("SGD", 0.05, {"device": 9}),
    ("AdamW", 0.1, {"device": 9})])
def test_linear_train_step_matches_jax(opt, lr, fallbacks):
    """``tests/test_sot_capture.py``'s linear model and loss: ten steps,
    the same losses and weights as the JAX TrainStep's."""
    nets = {}
    for pkg in PKGS:
        pkg.seed(0)
        nets[pkg] = pkg.nn.Linear(4, 1)
    _copy_params(nets[jpaddle], nets[tpaddle])
    x, y = _xy()
    steps, losses = {}, {}
    for pkg in PKGS:
        o = getattr(pkg.optimizer, opt)(learning_rate=lr,
                                        parameters=nets[pkg].parameters())
        step = (JaxTrainStep if pkg is jpaddle else TrainStep)(
            nets[pkg], _mse, o)
        steps[pkg] = step
        losses[pkg] = [float(step(pkg.to_tensor(x), pkg.to_tensor(y)))
                       for _ in range(10)]
    np.testing.assert_allclose(losses[tpaddle], losses[jpaddle], rtol=1e-5)
    assert losses[tpaddle][-1] < losses[tpaddle][0] * 0.7
    for (n, jp), tp in zip(nets[jpaddle].named_parameters(),
                           nets[tpaddle].parameters()):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp._data),
                                   atol=1e-6, rtol=1e-5, err_msg=n)
    st = steps[tpaddle].stats
    assert st["fallbacks"] == fallbacks and st["captured_steps"] == 0
    assert st["eager_steps"] == 1


def _model_pair(kind):
    from paddle_tpu.models.bert import BertConfig as JBertConfig
    from paddle_tpu.models.bert import BertForMaskedLM as JBert
    from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    jpaddle.seed(17)
    if kind == "llama":
        jm = JLlama(JLlamaConfig.tiny(num_hidden_layers=2,
                                      use_flash_attention=True))
        tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2,
                                               use_flash_attention=True),
                              device="cpu")
    else:
        jm = JBert(JBertConfig.tiny(num_hidden_layers=2, dropout=0.0))
        tm = BertForMaskedLM(BertConfig.tiny(num_hidden_layers=2,
                                             dropout=0.0), device="cpu")
    load_from_jax(tm, {n: np.asarray(p._data)
                       for n, p in jm.named_parameters()})
    return jm, tm


def _criteria(kind):
    if kind == "llama":
        from paddle_tpu.models.llama import LlamaPretrainingCriterion as J
        from paddle_tpu_torch.models.llama import \
            LlamaPretrainingCriterion as T
        return J(), T()
    return jpaddle.nn.CrossEntropyLoss(), tpaddle.nn.CrossEntropyLoss()


@pytest.mark.parametrize("kind", ["llama", "bert"])
def test_two_layer_model_steps_match_jax(kind):
    """Three AdamW TrainSteps on both sides from the same weights: the
    losses within 1e-5; AdamW turns a sign flip of a near-zero gradient
    into a whole lr step, so 99 % of the weights within 1e-5, all within
    3 lr x steps. The port ran its first step eager and counted the
    others ``"device"``."""
    lr, steps = 1e-3, 3
    jm, tm = _model_pair(kind)
    jcrit, tcrit = _criteria(kind)
    ids = np.random.default_rng(1).integers(0, 128, (2, 24)).astype(np.int32)
    tids = torch.from_numpy(ids).long()
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb),
                         jpaddle.optimizer.AdamW(learning_rate=lr,
                                                 parameters=jm.parameters()))
    tstep = TrainStep(tm, tcrit, AdamW(learning_rate=lr,
                                       parameters=tm.named_parameters()))
    jl = [float(jstep(jpaddle.to_tensor(ids), jpaddle.to_tensor(ids)))
          for _ in range(steps)]
    tl = [tstep(tids, tids) for _ in range(steps)]
    assert all(isinstance(x, torch.Tensor) and x.dtype == torch.float32
               and x.dim() == 0 and not x.requires_grad for x in tl)
    np.testing.assert_allclose([x.item() for x in tl], jl, rtol=1e-5)
    lin = linear_weight_names(tm)
    tparams = dict(tm.named_parameters())
    n_close = n_all = 0
    for name, p in jm.named_parameters():
        ref = np.asarray(p._data)
        ref = ref.T if name in lin else ref
        err = np.abs(tparams[name].detach().numpy() - ref)
        assert err.max() <= 3 * lr * steps, (name, float(err.max()))
        n_close += int((err <= 1e-5).sum())
        n_all += err.size
    assert n_close >= 0.99 * n_all, n_close / n_all
    assert tstep.stats["eager_steps"] == 1
    assert tstep.stats["fallbacks"] == {"device": steps - 1}


def _net_with_unused(pkg):
    pkg.seed(3)

    class Net(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pkg.nn.Linear(4, 1)
            self.unused = self.create_parameter(
                [5], default_initializer=pkg.nn.initializer.Constant(2.0))

        def forward(self, x):
            return self.fc(x)
    return Net()


def test_an_unreached_parameter_is_decayed_as_in_jax():
    """The JAX step differentiates the whole trainable tree: a parameter
    the loss does not reach gets a zero gradient, so AdamW only decays
    it. The port's step does the same (a zero gradient, eager here and
    inside the graph on the card)."""
    nets = {pkg: _net_with_unused(pkg) for pkg in PKGS}
    _copy_params(nets[jpaddle], nets[tpaddle])
    x, y = _xy()
    for pkg in PKGS:
        o = pkg.optimizer.AdamW(learning_rate=0.1, weight_decay=0.1,
                                parameters=nets[pkg].parameters())
        step = (JaxTrainStep if pkg is jpaddle else TrainStep)(
            nets[pkg], _mse, o)
        for _ in range(2):
            step(pkg.to_tensor(x), pkg.to_tensor(y))
    want = np.asarray(nets[jpaddle].unused._data)
    got = nets[tpaddle].unused.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, 2.0 * (1 - 0.1 * 0.1) ** 2, rtol=1e-6)


def test_the_loss_comes_back_in_f32():
    """``cast_loss_f32``: a loss function that returns bf16 gives an f32
    loss on both sides, and the port's engine is built with it."""
    x, y = _xy()
    out = {}
    for pkg in PKGS:
        pkg.seed(0)
        net = pkg.nn.Linear(4, 1)
        o = pkg.optimizer.AdamW(learning_rate=0.01,
                                parameters=net.parameters())
        step = (JaxTrainStep if pkg is jpaddle else TrainStep)(
            net, lambda a, b: _mse(a, b).astype("bfloat16"), o)
        out[pkg] = [step(pkg.to_tensor(x), pkg.to_tensor(y))
                    for _ in range(2)]
        if pkg is tpaddle:
            assert step._step._cast_f32 and not step._step._strict
    assert all(str(v.dtype) in ("float32", "paddle.float32",
                                "torch.float32") for v in out[jpaddle])
    assert all(v.dtype == torch.float32 for v in out[tpaddle])


def test_the_kill_switch_does_not_stop_train_step():
    """Non-strict: FLAGS_sot_capture=0 stops the hapi engine (nothing
    counted), not TrainStep, whose steps go through the engine (counted
    ``"device"`` here), as the JAX TrainStep ignores it."""
    from paddle_tpu_torch.jit.sot import CapturedStep
    x, y = _xy()
    tpaddle.seed(0)
    net = tpaddle.nn.Linear(4, 1)
    o = AdamW(learning_rate=0.01, parameters=net.parameters())
    step = TrainStep(net, _mse, o)
    strict = CapturedStep(net, _mse, o, mean_reduce=True)
    tpaddle.set_flags({"FLAGS_sot_capture": False})
    try:
        for _ in range(3):
            step(tpaddle.to_tensor(x), tpaddle.to_tensor(y))
        assert strict.step([tpaddle.to_tensor(x)],
                           [tpaddle.to_tensor(y)]) is None
    finally:
        tpaddle.set_flags({"FLAGS_sot_capture": True})
    assert step.stats["eager_steps"] == 1
    assert step.stats["fallbacks"] == {"device": 2}
    assert strict.stats["eager_steps"] == 0 and strict.stats["fallbacks"] \
        == {}


def test_a_plain_torch_module_goes_through_the_engine():
    """The port's models are plain ``torch.nn.Module``s fed torch
    tensors: the engine walks ``modules()`` for its gate and signature,
    keys the signature on the kind of tensors passed, and the step
    returns torch tensors."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                              torch.nn.Linear(8, 1))
    o = AdamW(learning_rate=0.01, parameters=net.named_parameters())
    step = TrainStep(net, _mse, o)
    x, y = (torch.from_numpy(a) for a in _xy())
    losses = [step(x, y) for _ in range(4)]
    assert all(isinstance(v, torch.Tensor) for v in losses)
    assert losses[-1] < losses[0]
    eng = step._step
    assert len(eng._sublayers) == 4
    assert step.stats["fallbacks"] == {"device": 3}
    sig = eng._signature("train", [x, y], 1, eng._tkeys(), None,
                         (False, False))
    assert sig[5][3] is False and sig[6][3] is False
    net.register_forward_hook(lambda *a: None)
    step(x, y)
    assert step.stats["fallbacks"] == {"device": 3, "hooks": 1}
