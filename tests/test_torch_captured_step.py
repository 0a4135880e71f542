"""The port's ``jit.sot.CapturedStep`` on the CPU: its gate against the
JAX package's, its signature and its two reasons of its own.

Each JAX setup that keeps a step out of capture (a layer or tensor hook,
no optimizer, an unknown clip, an optimizer that is not one fused step,
a trainable set that differs from the optimizer's, gradients pending
from an eager backward, a layer added after the engine was built, an
overridden GradScaler step) is built in both packages: both gates give
the same reason string. A clean setup passes both gates; on the CPU the
port then runs the first sighting eager and counts ``"device"`` where
the card would capture; a model whose first sighting made a host draw
from the port's generator (axis dropout) is counted under ``"rng"``,
one that drew only device keys (hash dropout) is not. The signature
keys on the batch, the modes, the trainable set, the optimizer's
statics, the clip, the scaler and the AMP regime, as the JAX one does.
"""
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu.jit.sot import CapturedStep as JaxCapturedStep
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.jit.sot import BucketPolicy, CapturedStep
from test_torch_tensor import port_on_cpu  # noqa: F401

ENGINES = {tpaddle: CapturedStep, jpaddle: JaxCapturedStep}


def _net(pkg, dropout=0.0, **drop_kw):
    pkg.seed(0)

    class Net(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pkg.nn.Linear(4, 8)
            self.drop = pkg.nn.Dropout(dropout, **drop_kw)
            self.fc2 = pkg.nn.Linear(8, 3)

        def forward(self, x):
            return self.fc2(self.drop(pkg.nn.functional.relu(self.fc1(x))))
    return Net()


def _loss(pkg):
    return pkg.nn.CrossEntropyLoss()


def _opt(pkg, net, **kw):
    params = kw.pop("parameters", None) or net.parameters()
    return pkg.optimizer.AdamW(1e-2, parameters=params, **kw)


def _engine(pkg, net, opt):
    return ENGINES[pkg](net, _loss(pkg), opt, mean_reduce=True)


def _batch(pkg):
    rng = np.random.default_rng(0)
    return ([pkg.to_tensor(rng.standard_normal((5, 4)).astype(np.float32))],
            [pkg.to_tensor(rng.integers(0, 3, (5,)))])


def _setup(pkg, case):
    net = _net(pkg)
    opt = _opt(pkg, net)
    scaler = None
    if case == "no_optimizer":
        opt = None
    elif case == "grad_clip":
        class MyClip(pkg.nn.ClipGradByGlobalNorm):
            pass
        opt = _opt(pkg, net, grad_clip=MyClip(1.0))
    elif case == "optimizer":
        opt._fusable_step = False
    elif case == "param_set":
        opt = _opt(pkg, net, parameters=net.fc1.parameters())
    elif case == "scaler":
        class MyScaler(pkg.amp.GradScaler):
            def step(self, optimizer):
                return super().step(optimizer)
        scaler = MyScaler(**({"device": "cpu"} if pkg is tpaddle else {}))
    eng = _engine(pkg, net, opt)
    if case == "hooks":
        net.fc2.register_forward_post_hook(lambda layer, i, o: None)
    elif case == "tensor_hooks":
        net.fc1.weight.register_hook(lambda g: g)
    elif case == "pending_grads":
        ins, lbl = _batch(pkg)
        _loss(pkg)(net(*ins), *lbl).backward()
    elif case == "network_changed":
        net.extra = pkg.nn.Linear(2, 2)
    return eng, scaler


CASES = ["hooks", "tensor_hooks", "no_optimizer", "grad_clip", "optimizer",
         "param_set", "pending_grads", "network_changed", "scaler"]


@pytest.mark.parametrize("case", CASES)
def test_gate_reason_matches_jax(case):
    reasons = []
    for pkg in (tpaddle, jpaddle):
        eng, scaler = _setup(pkg, case)
        reasons.append(eng._gate(train=True, scaler=scaler))
    want = "hooks" if case == "tensor_hooks" else case
    assert reasons == [want, want]


def test_clean_setup_passes_both_gates_and_eval_needs_no_optimizer():
    for pkg in (tpaddle, jpaddle):
        net = _net(pkg)
        eng = _engine(pkg, net, _opt(pkg, net))
        assert eng._gate(train=True) is None
        assert _engine(pkg, net, None)._gate(train=False) is None


def _train_batch(eng, net, opt, batch):
    """Model.train_batch's order: the engine first, else the eager step
    and eager_done."""
    ins, lbl = batch
    loss = eng.step(ins, lbl)
    if loss is None:
        loss = _loss(tpaddle)(net(*ins), *lbl)
        loss.backward()
        opt.step()
        opt.clear_grad()
        eng.eager_done()
    return loss


def test_cpu_runs_first_sighting_eager_then_counts_device():
    net = _net(tpaddle)
    opt = _opt(tpaddle, net)
    eng = _engine(tpaddle, net, opt)
    batch = _batch(tpaddle)
    for _ in range(3):
        _train_batch(eng, net, opt, batch)
    assert eng.stats["eager_steps"] == 1
    assert eng.stats["fallbacks"] == {"device": 2}
    assert eng.stats["captured_steps"] == 0 and eng.graphs() == {}
    assert opt._global_step == 3
    ins, lbl = batch
    net.eval()
    assert eng.forward(ins, lbl) is None     # first eval sighting
    assert eng.forward(ins, lbl) is None
    assert eng.stats["fallbacks"] == {"device": 3}


def test_a_first_sighting_that_drew_is_counted_rng():
    """Axis dropout seeds a Bernoulli generator on the host: its
    signature is counted ``"rng"``. Hash dropout draws its key from the
    device stream, which a graph may hold: its steps go on to
    ``"device"`` here, where the card would capture them."""
    hashed = _net(tpaddle, dropout=0.5)
    opt = _opt(tpaddle, hashed)
    eng = _engine(tpaddle, hashed, opt)
    for _ in range(3):
        _train_batch(eng, hashed, opt, _batch(tpaddle))
    assert eng.stats["eager_steps"] == 1
    assert eng.stats["fallbacks"] == {"device": 2}
    net = _net(tpaddle, dropout=0.5, axis=1)
    opt = _opt(tpaddle, net)
    eng = _engine(tpaddle, net, opt)
    batch = _batch(tpaddle)
    for _ in range(3):
        _train_batch(eng, net, opt, batch)
    assert eng.stats["eager_steps"] == 1
    assert eng.stats["fallbacks"] == {"rng": 2}
    # eval draws nothing (dropout is off): its sightings go on to "device"
    net.eval()
    ins, lbl = batch
    eng.forward(ins, lbl)
    eng.eager_done()
    eng.forward(ins, lbl)
    assert eng.stats["fallbacks"] == {"rng": 2, "device": 1}


def test_kill_switch_runs_eager_and_counts_nothing():
    net = _net(tpaddle)
    opt = _opt(tpaddle, net)
    eng = _engine(tpaddle, net, opt)
    tpaddle.set_flags({"FLAGS_sot_capture": False})
    try:
        for _ in range(2):
            _train_batch(eng, net, opt, _batch(tpaddle))
    finally:
        tpaddle.set_flags({"FLAGS_sot_capture": True})
    assert eng.stats["eager_steps"] == 0 and eng.stats["fallbacks"] == {}


def _sig(pkg, eng, batch, kind="train", scaler_statics=None):
    ins, lbl = batch
    arrays = eng._arrays(list(ins) + list(lbl))
    return eng._signature(kind, arrays, len(ins), eng._tkeys(),
                          scaler_statics)


def test_signature_fields_match_jax():
    sigs = {}
    for pkg in (tpaddle, jpaddle):
        net = _net(pkg)
        eng = _engine(pkg, net, _opt(pkg, net, grad_clip=pkg.nn.
                                     ClipGradByGlobalNorm(1.0)))
        with pkg.amp.auto_cast(level="O2"):
            sigs[pkg] = _sig(pkg, eng, _batch(pkg))
    t, j = sigs[tpaddle], sigs[jpaddle]
    # kind, n_ins, modes, trainable names in order
    assert t[:4] == j[:4]
    assert t[4][0] is j[4][0] is True and t[4][2] == j[4][2] == "O2"
    assert [a[:1] for a in t[5:7]] == [a[:1] for a in j[5:7]]
    assert t[7][0] == j[7][0] == "AdamW"
    # per-parameter decays (JAX keeps a (decay, lr ratio) pair each)
    assert t[7][2] == tuple(d for d, _ in j[7][2])
    assert t[7][3] == j[7][3] == ("global_norm", 1.0)


def test_signature_changes_with_each_field():
    net = _net(tpaddle)
    opt = _opt(tpaddle, net)
    eng = _engine(tpaddle, net, opt)
    batch = _batch(tpaddle)
    base = _sig(tpaddle, eng, batch)
    assert _sig(tpaddle, eng, batch) == base
    seen = {base}

    def fresh(sig):
        assert sig not in seen
        seen.add(sig)
    ins, lbl = batch
    fresh(_sig(tpaddle, eng, ([ins[0][:3]], [lbl[0][:3]])))  # shapes
    fresh(_sig(tpaddle, eng, ([ins[0].astype("float64")], lbl)))  # dtype
    net.eval()
    fresh(_sig(tpaddle, eng, batch))                             # modes
    net.train()
    with tpaddle.amp.auto_cast():
        fresh(_sig(tpaddle, eng, batch))                         # AMP
    fresh(_sig(tpaddle, eng, batch, scaler_statics=tpaddle.amp.GradScaler(
        device="cpu").capture_statics(opt)))                     # scaler
    opt._beta1 = 0.8
    fresh(_sig(tpaddle, eng, batch))                             # hyper
    opt._grad_clip = tpaddle.nn.ClipGradByValue(1.0)
    fresh(_sig(tpaddle, eng, batch))                             # clip
    net.fc2.bias.stop_gradient = True
    fresh(_sig(tpaddle, eng, batch))                             # trainables
    fresh(_sig(tpaddle, eng, batch, kind="eval"))
    opt._beta1 = tpaddle.to_tensor(0.8)._t
    assert eng._gate(train=True) == "hyper"


def test_bucket_policy_pads_like_jax():
    x = np.arange(10, dtype=np.int64).reshape(2, 5)
    for buckets in ([4, 8, 16], "pow2"):
        got = BucketPolicy({0: {1: buckets}}, pad_value=-100).apply(
            (tpaddle.to_tensor(x), 3))
        from paddle_tpu.jit.sot import BucketPolicy as JB
        want = JB({0: {1: buckets}}, pad_value=-100).apply(
            (jpaddle.to_tensor(x), 3))
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.asarray(want[0]._data))
        assert got[1] == 3 and got[0].shape == [2, 8]
