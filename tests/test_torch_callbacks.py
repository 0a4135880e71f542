"""The port's hapi callbacks against the JAX package's, on the CPU.

The same small regression (``Linear(4, 1)``, ``MSELoss``,
AdamW, 12 samples in batches of 4, an eval set) is fitted by both
packages' ``Model`` with the same callbacks: the sequence of hook calls
(with their steps and epochs) is the same, ``History`` holds the same
keys and per-epoch losses (1e-4 relative), ``EarlyStopping`` stops at
the same epoch and restores the same best weights, ``ModelCheckpoint``
writes the same files, ``LRScheduler`` steps the lr the same way per
batch and per epoch, ``VisualDL`` records the same tags and steps, and
``MetricsLogger`` closes one StepTimer step a batch.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.observability import timeline
from test_torch_tensor import port_on_cpu  # noqa: F401

RTOL = 1e-4
_R = np.random.default_rng(0)
X = _R.standard_normal((12, 4)).astype(np.float32)
Y = (X @ np.float32([[1.0], [-2.0], [0.5], [0.0]]) + 0.1).astype(np.float32)


def _model(pkg, lr=0.05):
    pkg.seed(0)
    net = pkg.nn.Linear(4, 1)
    if pkg is tpaddle:
        # the same initial weights on both sides
        jpaddle.seed(0)
        j = jpaddle.nn.Linear(4, 1)
        net.set_state_dict({k: np.asarray(v._data)
                            for k, v in j.state_dict().items()})
    opt = pkg.optimizer.AdamW(lr, parameters=net.parameters())
    return pkg.Model(net).prepare(opt, pkg.nn.MSELoss()), net


def _recorder(pkg):
    class Rec(pkg.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __getattribute__(self, name):
            if name.startswith("on_"):
                calls = object.__getattribute__(self, "calls")

                def hook(*args):
                    calls.append((name,) + tuple(
                        a for a in args if isinstance(a, int)))
                return hook
            return object.__getattribute__(self, name)
    return Rec()


def _fit(pkg, callbacks, epochs=3, **kw):
    m, net = _model(pkg, **{k: kw.pop(k) for k in list(kw) if k == "lr"})
    hist = m.fit((X, Y), batch_size=4, epochs=epochs, verbose=0,
                 shuffle=False, eval_data=(X[:8], Y[:8]),
                 callbacks=callbacks, **kw)
    return m, net, hist


def test_event_order_and_history_match_jax():
    recs = {}
    hists = {}
    for pkg in (tpaddle, jpaddle):
        rec = _recorder(pkg)
        _, _, hists[pkg] = _fit(pkg, [rec])
        recs[pkg] = rec.calls
    assert recs[tpaddle] == recs[jpaddle]
    assert recs[tpaddle][0] == ("on_train_begin",)
    assert ("on_train_batch_end", 2) in recs[tpaddle]
    assert recs[tpaddle].count(("on_eval_begin",)) == 3
    th, jh = hists[tpaddle], hists[jpaddle]
    assert th.keys() == jh.keys() == {"loss", "eval_loss"}
    for k in th:
        for a, b in zip(th[k], jh[k]):
            assert abs(a - b) <= RTOL * abs(b), (k, a, b)


def test_early_stopping_matches_jax():
    out = {}
    for pkg in (tpaddle, jpaddle):
        # "max" on a falling loss: no eval improves after the first
        es = pkg.callbacks.EarlyStopping(monitor="loss", mode="max",
                                         patience=1, verbose=0)
        m, net, hist = _fit(pkg, [es], epochs=5)
        w = net.weight.numpy() if pkg is tpaddle else \
            np.asarray(net.weight._data)
        out[pkg] = (es.stopped_epoch, m.stop_training, len(hist["loss"]), w,
                    es.best)
    t, j = out[tpaddle], out[jpaddle]
    assert t[:3] == j[:3] == (1, True, 2)
    np.testing.assert_allclose(t[3], j[3], rtol=RTOL, atol=1e-6)
    assert abs(t[4] - j[4]) <= RTOL * abs(j[4])


def test_model_checkpoint_writes_the_same_files(tmp_path):
    names = {}
    for pkg, sub in ((tpaddle, "t"), (jpaddle, "j")):
        d = tmp_path / sub
        _fit(pkg, [pkg.callbacks.ModelCheckpoint(save_freq=2,
                                                 save_dir=str(d))])
        names[sub] = sorted(os.listdir(d))
    assert names["t"] == names["j"] == sorted(
        f"{e}.{x}" for e in ("0", "2", "final") for x in ("pdparams",
                                                          "pdopt"))
    # the port's final checkpoint loads in the JAX package
    jm, _ = _model(jpaddle)
    jm.load(str(tmp_path / "t" / "final"))


@pytest.mark.parametrize("by_step", [True, False])
def test_lr_scheduler_callback_matches_jax(by_step):
    lrs = {}
    for pkg in (tpaddle, jpaddle):
        pkg.seed(0)
        net = pkg.nn.Linear(4, 1)
        sched = pkg.optimizer.lr.StepDecay(0.1, step_size=2 if by_step
                                           else 1, gamma=0.5)
        opt = pkg.optimizer.AdamW(sched, parameters=net.parameters())
        m = pkg.Model(net).prepare(opt, pkg.nn.MSELoss())
        seen = []

        class Peek(pkg.callbacks.Callback):
            def on_train_batch_begin(self, step, logs=None):
                seen.append(opt.get_lr())
        m.fit((X, Y), batch_size=4, epochs=2, verbose=0, shuffle=False,
              callbacks=[Peek(), pkg.callbacks.LRScheduler(
                  by_step=by_step, by_epoch=not by_step)])
        lrs[pkg] = seen
    assert lrs[tpaddle] == lrs[jpaddle]
    assert len(set(lrs[tpaddle])) > 1


def test_visualdl_records_match_jax(tmp_path):
    recs = {}
    for pkg, sub in ((tpaddle, "t"), (jpaddle, "j")):
        _fit(pkg, [pkg.callbacks.VisualDL(log_dir=str(tmp_path / sub))],
             epochs=2)
        with open(tmp_path / sub / "scalars.jsonl") as f:
            recs[sub] = [json.loads(line) for line in f]
    assert [(r["tag"], r["step"]) for r in recs["t"]] == \
        [(r["tag"], r["step"]) for r in recs["j"]]
    for a, b in zip(recs["t"], recs["j"]):
        assert abs(a["value"] - b["value"]) <= RTOL * (1 + abs(b["value"]))


def test_metrics_logger_and_progbar(capsys):
    ml = tpaddle.callbacks.MetricsLogger(log_freq=2)
    _fit(tpaddle, [ml, tpaddle.callbacks.ProgBarLogger(1, verbose=2)],
         epochs=1)
    assert ml.timer.step_index == 3
    assert ml.timer in timeline.active_timers()
    ev = ml.timer.chrome_events()
    assert len(ev) == 3 and ev[0]["ph"] == "C" and "step" in ev[0]["args"]
    out = capsys.readouterr().out
    assert "Epoch 1/1" in out and "step 2: loss:" in out
    assert "[metrics] step 0" in out and "captured_steps=" in out
    from paddle_tpu_torch.observability import metrics
    assert metrics.default_registry().get("train.loss") is not None


def test_config_callbacks_defaults_match_jax():
    from paddle_tpu.hapi.callbacks import config_callbacks as jcfg
    from paddle_tpu_torch.hapi.callbacks import config_callbacks as tcfg
    for kw in (dict(verbose=2), dict(verbose=0, save_dir="x")):
        t, _ = tcfg(None, epochs=2, **kw)
        j, _ = jcfg(None, epochs=2, **kw)
        assert [type(c).__name__ for c in t.callbacks] == \
            [type(c).__name__ for c in j.callbacks]
