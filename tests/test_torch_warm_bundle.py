"""Warm bundles for the port's captured steps, on the CPU: a
``hapi.Model`` and a ``jit.TrainStep`` record ``captured_step`` entries
(the JAX package's fields; a bundle the JAX loader reads), a fresh model
pre-warmed from the exported bundle is unchanged by the pre-warm (its
steps run eager here and are counted ``"device"``), and its next steps
equal a cold model's; ``sig_to_json`` / ``sig_from_json`` round-trip
the JAX encodings; an unknown build is counted and pre-warm goes on.
These replace the test that pinned ``prepare(warm_bundle=)`` as not
ported."""
import numpy as np
import pytest
import torch

import paddle_tpu.jit.warmup as jwarmup
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit import warmup
from test_torch_tensor import port_on_cpu  # noqa: F401

X = np.random.default_rng(0).random((3, 4)).astype(np.float32)
Y = np.random.default_rng(1).random((3, 2)).astype(np.float32)


def _net():
    tpaddle.seed(0)
    net = tpaddle.nn.Sequential(tpaddle.nn.Linear(4, 8), tpaddle.nn.ReLU(),
                                tpaddle.nn.Linear(8, 2))
    opt = tpaddle.optimizer.AdamW(learning_rate=0.01,
                                  parameters=net.parameters())
    return net, opt


def _model(amp=None, bundle=None):
    net, opt = _net()
    m = tpaddle.Model(net)
    m.prepare(opt, tpaddle.nn.MSELoss(), amp_configs=amp,
              warm_bundle=bundle)
    return m


def _state(m):
    opt = m._optimizer
    return ({k: v.numpy().copy() for k, v in m.network.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()}
             for i, s in opt._states.items()},
            opt._global_step, tpaddle.get_rng_state())


@pytest.fixture
def bundle(tmp_path):
    warmup.clear_recorded()
    m = _model()
    for _ in range(3):
        m.train_batch([X], [Y])
    for _ in range(2):
        m.eval_batch([X], [Y])
    path = warmup.export_bundle(str(tmp_path / "warm_bundle.json"))
    warmup.clear_recorded()
    return path


def test_model_records_the_jax_fields(bundle):
    loaded = jwarmup.load_bundle(bundle)        # the JAX loader reads it
    entries = [e for e in loaded["entries"] if e["kind"] == "captured_step"]
    assert sorted(e["build"] for e in entries) == ["eval", "train"]
    train = next(e for e in entries if e["build"] == "train")
    assert train["name"] == "hapi.step" and train["n_ins"] == 1
    assert train["batch"] == [[[3, 4], "float32"], [[3, 2], "float32"]]
    assert train["scaler"] is None
    assert warmup.sig_from_json(train["sig"])[0] == "train"


def test_prewarm_leaves_the_model_as_it_was(bundle):
    cold = _model()
    before = _state(cold)
    warm = _model(bundle=bundle)
    after = _state(warm)
    for k, v in before[0].items():
        np.testing.assert_array_equal(after[0][k], v)
    # the states the pre-warm made are at their initial values
    opt = warm._optimizer
    for i, st in after[1].items():
        init = opt._init_state(opt._parameter_list[i])
        for k, v in st.items():
            assert torch.equal(v, init[k]), (i, k)
    assert after[2] == before[2] == 0
    assert after[3] == before[3]
    assert warm.network.training == cold.network.training
    stats = warm._captured.stats
    assert stats["eager_steps"] == 2 and stats["fallbacks"] == {"device": 2}
    # the next steps equal a cold model's
    for m in (cold, warm):
        m._losses = [float(m.train_batch([X], [Y])[0]) for _ in range(2)]
    assert warm._losses == cold._losses
    for a, b in zip(warm.network.parameters(), cold.network.parameters()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_prewarm_puts_a_grad_scaler_back(tmp_path):
    amp = {"level": "O1", "init_loss_scaling": 1024.0}
    warmup.clear_recorded()
    m = _model(amp)
    for _ in range(2):
        m.train_batch([X], [Y])
    path = warmup.export_bundle(str(tmp_path / "b.json"))
    warmup.clear_recorded()
    builds = [e["build"] for e in warmup.load_bundle(path)["entries"]]
    assert builds == ["train_scaled"]
    warm = _model(amp, bundle=path)
    sc = warm._scaler
    assert float(sc._scale) == 1024.0 and int(sc._good_steps) == 0
    assert warm._captured.stats["eager_steps"] == 1


def test_train_step_takes_a_bundle(tmp_path):
    warmup.clear_recorded()
    net, opt = _net()
    step = TrainStep(net, tpaddle.nn.MSELoss(), opt)
    x, y = torch.from_numpy(X), torch.from_numpy(Y)
    for _ in range(2):
        step(x, y)
    entries = warmup.recorded()
    assert [e["name"] for e in entries] == ["train_step"]
    net2, opt2 = _net()
    before = [p.numpy().copy() for p in net2.parameters()]
    rng = tpaddle.get_rng_state()
    step2 = TrainStep(net2, tpaddle.nn.MSELoss(), opt2,
                      warm_bundle={"__paddle_tpu_warm_bundle__": 1,
                                   "entries": entries})
    warmup.clear_recorded()
    for a, b in zip(net2.parameters(), before):
        np.testing.assert_array_equal(a.numpy(), b)
    assert opt2._global_step == 0 and tpaddle.get_rng_state() == rng
    assert step2.stats["eager_steps"] == 1


def test_sig_json_round_trips_the_jax_encodings():
    sig = ("train", 1, (True, False), ("0.weight",),
           (False, "None", "O1", (), ()), ((3, 4), "float32", "cpu", True),
           ("AdamW", (("_beta1", 0.9),), (0.0, 0.01), None), 2.5)
    enc = warmup.sig_to_json(sig)
    assert enc == jwarmup.sig_to_json(sig)
    assert warmup.sig_from_json(enc) == jwarmup.sig_from_json(enc) == sig
    assert warmup.sig_from_json(warmup.sig_to_json(())) == ()


def test_unknown_build_is_counted_and_prewarm_goes_on(bundle):
    m = _model()
    bad = {"kind": "captured_step", "name": "hapi.step", "build": "bogus"}
    good = warmup.load_bundle(bundle)["entries"]
    with pytest.raises(ValueError, match="unknown captured_step build"):
        m._capture_engine().prewarm(bad)
    failed = warmup._M_failures.value(reason="program")
    out = warmup.prewarm({"__paddle_tpu_warm_bundle__": 1,
                          "entries": [bad] + good + [{"kind": "serving"}]},
                         captured=m._capture_engine())
    assert out == {"programs": 2, "failures": 1, "skipped": 1}
    assert warmup._M_failures.value(reason="program") == failed + 1
    # the JAX prewarm gives the same account of a bad entry
    assert jwarmup.prewarm({"__paddle_tpu_warm_bundle__": 1,
                            "entries": [bad]},
                           captured=_JaxBogus()) == \
        {"programs": 0, "failures": 1, "skipped": 0}


class _JaxBogus:
    def prewarm(self, entry):
        raise ValueError(f"unknown captured_step build {entry['build']!r}")


def test_an_engine_holds_its_owners_step_weakly():
    """A ``Model`` or ``TrainStep`` and its ``CapturedStep`` form no
    reference cycle through the prewarm step runner: dropping the owner frees
    the engine (and the graphs it holds) at once, never later in the
    cyclic collector, which may run inside another engine's capture."""
    import gc
    import weakref
    net, opt = _net()
    m = _model()
    engine = weakref.ref(m._capture_engine())
    assert engine().step_runner == m._prewarm_step
    gc.disable()
    try:
        del m
        assert engine() is None
        step = TrainStep(net, tpaddle.nn.MSELoss(), opt)
        engine = weakref.ref(step._step)
        del step
        assert engine() is None
    finally:
        gc.enable()
