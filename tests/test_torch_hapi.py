"""The port's ``paddle.Model`` against the JAX package's, on the CPU.

A 2-layer GPT (hidden 32, 2 heads, vocab 128) is built by the JAX
package and copied into the port through ``convert``; both
``Model.prepare(AdamW(1e-3, ClipGradByGlobalNorm(1.0)), CrossEntropyLoss
over logits.reshape([-1, vocab]), Accuracy())`` then ``fit`` 2 epochs of
4 batches (f32, ``shuffle=False``) with an eval set, ``evaluate`` and
``predict``: per-epoch losses and eval losses within 1e-4 relative, the
same history keys, predictions within 1e-4. (The JAX side runs its
captured whole-step program; the port on the CPU runs eager, see
``tests/test_torch_captured_step.py``.) Each package loads the other's
``Model.save`` files: the parameters and optimizer states bit for bit,
and one more step from the loaded state gives the same loss. ``summary`` and
``flops`` give the JAX totals; ``amp_configs`` parse and fail as the
JAX ones do.
"""
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.convert import gpt_from_jax
from test_torch_tensor import port_on_cpu  # noqa: F401

RTOL = 1e-4
CFG = dict(hidden_size=32, num_attention_heads=2)


def _loss(pkg, vocab):
    crit = pkg.nn.CrossEntropyLoss()

    def loss(logits, labels):
        return crit(logits.reshape([-1, vocab]), labels.reshape([-1]))
    return loss


def _prepare(pkg, net, vocab):
    opt = pkg.optimizer.AdamW(1e-3, parameters=net.parameters(),
                              grad_clip=pkg.nn.ClipGradByGlobalNorm(1.0))
    return pkg.Model(net).prepare(opt, _loss(pkg, vocab),
                                  metrics=pkg.metric.Accuracy())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from paddle_tpu_torch.core import device as tdevice
    prev = tdevice._current
    tdevice.set_device("cpu")
    cfg = JaxGPTConfig.tiny(**CFG)
    jpaddle.seed(11)
    jnet = JaxGPT(cfg)
    arrays = {n: np.asarray(p._data) for n, p in jnet.named_parameters()}
    tnet = gpt_from_jax(cfg, arrays)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (16, 16))
    ev = rng.integers(0, cfg.vocab_size, (8, 16))
    out = {}
    tmp = tmp_path_factory.mktemp("hapi")
    for name, pkg, net in (("jax", jpaddle, jnet), ("port", tpaddle, tnet)):
        m = _prepare(pkg, net, cfg.vocab_size)
        hist = m.fit((ids, ids), batch_size=4, epochs=2, verbose=0,
                     shuffle=False, eval_data=(ev, ev))
        evl = m.evaluate((ev, ev), batch_size=4, verbose=0)
        pred = m.predict((ev[:4], ev[:4]), batch_size=2, stack_outputs=True)
        m.save(str(tmp / name / "ckpt"))
        out[name] = dict(model=m, net=net, hist=hist, eval=evl, pred=pred,
                         path=str(tmp / name / "ckpt"))
    out.update(cfg=cfg, ids=ids)
    yield out
    tdevice._current = prev


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_fit_losses_match_jax(runs):
    jh, th = runs["jax"]["hist"], runs["port"]["hist"]
    assert th.keys() == jh.keys() == {"loss", "eval_loss", "eval_acc"}
    for k in ("loss", "eval_loss"):
        assert len(th[k]) == len(jh[k]) == 2
        for a, b in zip(th[k], jh[k]):
            assert _rel(a, b) <= RTOL, (k, a, b)
    np.testing.assert_allclose(th["eval_acc"], jh["eval_acc"], atol=1e-6)
    assert th["loss"][1] < th["loss"][0]


def test_evaluate_and_predict_match_jax(runs):
    je, te = runs["jax"]["eval"], runs["port"]["eval"]
    assert te.keys() == je.keys() == {"loss", "acc"}
    assert _rel(te["loss"], je["loss"]) <= RTOL
    (tp,), (jp,) = runs["port"]["pred"], runs["jax"]["pred"]
    assert tp.shape == jp.shape == (4, 16, runs["cfg"].vocab_size)
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=RTOL)


def test_each_package_loads_the_others_files(runs):
    cfg, ids = runs["cfg"], runs["ids"]
    jnet, tnet = runs["jax"]["net"], runs["port"]["net"]
    # port <- JAX
    tm = _prepare(tpaddle, gpt_from_jax(cfg, {
        n: np.zeros(p.shape, np.float32)
        for n, p in jnet.named_parameters()}), cfg.vocab_size)
    tm.load(runs["jax"]["path"])
    for (n, p), (_, q) in zip(tm.network.named_parameters(),
                              jnet.named_parameters()):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q._data), n)
    assert tm._optimizer._global_step == 8
    # JAX <- port
    jpaddle.seed(99)
    jm = _prepare(jpaddle, JaxGPT(cfg), cfg.vocab_size)
    jm.load(runs["port"]["path"])
    for (n, p), (_, q) in zip(jm.network.named_parameters(),
                              tnet.named_parameters()):
        np.testing.assert_array_equal(np.asarray(p._data), q.numpy(), n)
    # the optimizer states bit for bit, and one more step from each
    # loaded state gives the same loss
    ts = tm._optimizer.state_dict()
    js = runs["jax"]["model"]._optimizer.state_dict()
    assert ts.keys() == js.keys()
    for k, v in js.items():
        if k.startswith("param_"):
            np.testing.assert_array_equal(
                ts[k].numpy(), np.asarray(v._data).reshape(ts[k].shape), k)
    x = ids[:4]
    lt = float(tm.train_batch(x, x)[0])
    lj = float(jm.train_batch(x, x)[0])
    assert _rel(lt, lj) <= RTOL


def test_summary_and_flops_totals_match_jax(capsys):
    cfg = JaxGPTConfig.tiny(**CFG)
    jpaddle.seed(1)
    jnet = JaxGPT(cfg)
    tnet = gpt_from_jax(cfg, {n: np.asarray(p._data)
                              for n, p in jnet.named_parameters()})
    want = jpaddle.summary(jnet, input_size=[2, 16], dtypes="int64")
    got = tpaddle.summary(tnet, input_size=[2, 16], dtypes="int64")
    assert got == want and got["total_params"] > 0
    assert "Total params" in capsys.readouterr().out
    assert tpaddle.Model(tnet).summary([2, 16], "int64") == want

    def mlp(pkg):
        pkg.seed(0)
        return pkg.nn.Sequential(pkg.nn.Linear(8, 16), pkg.nn.LayerNorm(16),
                                 pkg.nn.GELU(), pkg.nn.Linear(16, 4))
    assert tpaddle.flops(mlp(tpaddle), [3, 8]) == \
        jpaddle.flops(mlp(jpaddle), [3, 8]) == 3 * 8 * 16 + 3 * 16 * 2 \
        + 3 * 16 * 4


@pytest.mark.parametrize("cfg,err", [
    ({"level": "O1", "bogus": 1}, "unknown amp_configs keys"),
    ({"level": "O1", "scaler": object(), "init_loss_scaling": 8.0},
     "both an explicit scaler"),
])
def test_amp_config_errors_match_jax(cfg, err):
    for pkg in (tpaddle, jpaddle):
        with pytest.raises(ValueError, match=err):
            pkg.Model._parse_amp(dict(cfg))


def test_amp_config_parsing_matches_jax():
    for cfg in ("O0", None, "o2", {"level": "O1", "use_fp16_guard": True},
                {"level": "O1", "init_loss_scaling": 1024.0},
                {"dtype": "float16"}):
        t_amp, t_sc = tpaddle.Model._parse_amp(cfg)
        j_amp, j_sc = jpaddle.Model._parse_amp(cfg)
        assert t_amp == j_amp
        assert (t_sc is None) == (j_sc is None)
        if t_sc is not None:
            assert float(t_sc._scale) == float(j_sc._scale)
