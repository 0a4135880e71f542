"""The port's ``amp.auto_cast`` / ``decorate`` against the JAX package's,
on the CPU.

Every op of the white and black lists that the port has runs under
``auto_cast`` at O1 and O2, on f32 and on bf16 inputs, on both sides:
the output dtypes agree (the cast hook of ``apply_op`` keys on the JAX
op names). ``decorate``, ``amp_signature`` and a 2-layer GPT forward
under O1 (weights copied through ``convert``; its linears run in bf16,
its norms and loss in f32) are held against the JAX package: logits
within 2e-2 relative RMS, the loss within 2e-2 relative.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.convert import gpt_from_jax
from test_torch_tensor import port_on_cpu  # noqa: F401

REL_RMS = 2e-2
# the modules (each package's amp exports a class of the same name)
tac = importlib.import_module("paddle_tpu_torch.amp.auto_cast")
jac = importlib.import_module("paddle_tpu.amp.auto_cast")


def _np_dtype(t):
    d = t._t.dtype if isinstance(t, tpaddle.Tensor) else t.dtype
    return str(d).replace("torch.", "")


def _jax_dtype(t):
    return str(np.asarray(t._data).dtype) if not hasattr(t._data, "dtype") \
        else str(t._data.dtype)


def _inputs(dtype):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 4, 8)).astype(np.float32)
    b = rng.standard_normal((2, 8, 4)).astype(np.float32)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    ln_w = rng.standard_normal((8,)).astype(np.float32)
    lbl = rng.integers(0, 8, (2, 4)).astype(np.int64)
    pos = np.abs(a) + 0.5
    return dict(a=a, b=b, w=w, ln_w=ln_w, lbl=lbl, pos=pos, dtype=dtype)


# name -> f(pkg, t) where t(name) gives that side's tensor of an input
_OPS = {
    "matmul": lambda P, t: P.matmul(t("a"), t("b")),
    "mm": lambda P, t: P.mm(t("a")[0], t("b")[0]),
    "bmm": lambda P, t: P.bmm(t("a"), t("b")),
    "einsum": lambda P, t: P.einsum("bij,bjk->bik", t("a"), t("b")),
    "linear": lambda P, t: P.nn.functional.linear(t("a"), t("w")),
    "sdpa": lambda P, t: P.nn.functional.scaled_dot_product_attention(
        t("a")[None], t("a")[None], t("a")[None]),
    "softmax": lambda P, t: P.nn.functional.softmax(t("a")),
    "log_softmax": lambda P, t: P.nn.functional.log_softmax(t("a")),
    "cross_entropy": lambda P, t: P.nn.functional.cross_entropy(
        t("a"), t("lbl")),
    "layer_norm": lambda P, t: P.nn.functional.layer_norm(
        t("a"), [8], t("ln_w")),
    "rms_norm": lambda P, t: P.nn.functional.rms_norm(t("a"), t("ln_w")),
    "exp": lambda P, t: P.exp(t("a")),
    "log": lambda P, t: P.log(t("pos")),
    "mean": lambda P, t: P.mean(t("a")),
    "sum": lambda P, t: P.sum(t("a")),
    "logsumexp": lambda P, t: P.logsumexp(t("a"), axis=-1),
    "cumsum": lambda P, t: P.cumsum(t("a"), axis=-1),
    # an op on neither list: passes its inputs through
    "add": lambda P, t: P.add(t("a"), t("a")),
}


def _run(pkg, level, inputs):
    dt = inputs["dtype"]

    def t(name):
        v = inputs[name]
        x = pkg.to_tensor(v)
        if v.dtype == np.float32 and dt == "bfloat16" and name != "ln_w":
            x = x.astype("bfloat16")
        return x
    with pkg.amp.auto_cast(level=level):
        return _OPS[inputs["op"]](pkg, t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op", sorted(_OPS))
def test_list_ops_output_dtypes_match_jax(op, level, dtype):
    inputs = dict(_inputs(dtype), op=op)
    got = _run(tpaddle, level, inputs)
    want = _run(jpaddle, level, inputs)
    assert _np_dtype(got) == _jax_dtype(want), (op, level, dtype)


def test_lists_match_jax():
    assert tac.WHITE_LIST == jac.WHITE_LIST
    assert tac.BLACK_LIST == jac.BLACK_LIST
    assert tpaddle.amp.white_list() == jac.white_list()


def test_custom_lists_move_an_op():
    x = tpaddle.to_tensor(np.ones((2, 2), np.float32))
    with tpaddle.amp.auto_cast(custom_black_list={"matmul"}):
        assert tpaddle.matmul(x, x).dtype == torch.float32
    with tpaddle.amp.auto_cast(custom_white_list={"add"}):
        assert tpaddle.add(x, x).dtype == torch.bfloat16
    with tpaddle.amp.auto_cast(enable=False):
        assert tpaddle.matmul(x, x).dtype == torch.float32
    assert not tac.amp_state().enabled


def test_amp_signature_tracks_the_regime_as_jax_does():
    regimes = [dict(), dict(level="O2"), dict(custom_white_list={"add"}),
               dict(custom_black_list={"matmul"}, level="O2"),
               dict(enable=False)]
    sigs = []
    for kw in regimes:
        with tpaddle.amp.auto_cast(**kw), jpaddle.amp.auto_cast(**kw):
            t, j = tac.amp_signature(), jac.amp_signature()
        # the dtype's name differs by package (torch.bfloat16 / bfloat16)
        assert (t[0],) + t[2:] == (j[0],) + j[2:]
        assert "bfloat16" in t[1]
        sigs.append(t)
    assert len(set(sigs)) == len(regimes)
    assert tac.amp_signature()[0] is False


def test_decorate_matches_jax():
    cfg = JaxGPTConfig.tiny(hidden_size=32, num_attention_heads=2)
    jpaddle.seed(3)
    jm = JaxGPT(cfg)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    for level in ("O1", "O2"):
        tm = gpt_from_jax(cfg, arrays, device="cpu")
        jm2 = JaxGPT(cfg)
        opt = tpaddle.optimizer.AdamW(parameters=tm.parameters())
        m, o = tpaddle.amp.decorate(tm, opt, level=level)
        assert m is tm and o is opt
        jpaddle.amp.decorate(jm2, level=level)
        want = {n: str(p._data.dtype) for n, p in jm2.named_parameters()}
        got = {n: _np_dtype(p) for n, p in tm.named_parameters()}
        assert got == want
    assert tpaddle.amp.decorate(tm) is tm


def test_gpt_forward_under_auto_cast_matches_jax():
    cfg = JaxGPTConfig.tiny()
    jpaddle.seed(11)
    jm = JaxGPT(cfg)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = gpt_from_jax(cfg, arrays, device="cpu")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    out = {}
    for name, pkg, net in (("jax", jpaddle, jm), ("port", tpaddle, tm)):
        x = pkg.to_tensor(ids)
        with pkg.amp.auto_cast(level="O1"):
            logits = net(x)
            loss = pkg.nn.CrossEntropyLoss()(
                logits.reshape([-1, cfg.vocab_size]), x.reshape([-1]))
        out[name] = (logits, loss)
    (jl, jloss), (tl, tloss) = out["jax"], out["port"]
    assert _np_dtype(tl) == _jax_dtype(jl) == "bfloat16"
    assert _np_dtype(tloss) == _jax_dtype(jloss) == "float32"
    a = tl.numpy().astype(np.float64)
    b = np.asarray(jl._data.astype("float32"), dtype=np.float64)
    rel = np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2))
    assert rel < REL_RMS, rel
    assert abs(float(tloss) - float(jloss)) / abs(float(jloss)) < REL_RMS
