"""The port's ``nn.Layer`` against the JAX package's, on the CPU, and the
classes the earlier slices' torch models hold, from a torch parent.

One model of paddle user code (Linear, LayerList, LayerNorm,
Sequential, Dropout, a registered buffer, a plain Tensor attribute, a
``create_parameter``) is built by each package: parameter names,
order and shapes, state-dict keys and order, buffers, sublayers,
modes, hooks, ``apply``'s order, ``to`` / ``astype`` / ``bfloat16``
and ``set_state_dict`` must agree, and with the JAX weights copied in
the forward and its gradients agree within 1e-5 (f32: the two sum in
other orders). The layers and
functionals GPT and Llama-style code use are held to the JAX ones one
by one (forward and gradients). A ``torch.nn.Module`` parent (as BERT
and ERNIE-MoE are) holding ``LayerNorm``, ``Dropout``, ``GPTAttention``
and a ``TransformerEncoderLayer`` gets torch tensors and torch's
meanings of ``parameters``, ``named_parameters``, ``state_dict``,
``to``, ``apply`` and ``register_forward_pre_hook``; the same Layers
called with Tensors return Tensors.
"""
from collections import OrderedDict

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.convert import load_layer_from_jax
from paddle_tpu_torch.models.gpt import GPTAttention, GPTConfig
from test_torch_tensor import compare, port_on_cpu  # noqa: F401

TOL = 1e-5


def _mlp(P):
    nn = P.nn

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(4, 8)
            self.blocks = nn.LayerList([nn.Linear(8, 8), nn.Linear(8, 8)])
            self.norm = nn.LayerNorm(8)
            self.head = nn.Sequential(nn.Linear(8, 3), nn.Dropout(0.0))
            self.register_buffer("steps", P.zeros([1]))
            self.scratch = P.ones([2])      # a non-persistable buffer
            self.extra = self.create_parameter([3], is_bias=True)
            self.frozen = self.create_parameter(
                [2], attr=nn.ParamAttr(initializer=nn.initializer.Constant(
                    0.5), trainable=False))
            self.nothing = self.create_parameter([2], attr=False)

        def forward(self, x):
            h = P.nn.functional.gelu(self.fc1(x))
            for blk in self.blocks:
                h = h + blk(h)
            return self.head(self.norm(h)) + self.extra
    return MLP()


def _jax_arrays(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


@pytest.fixture
def pair():
    jpaddle.seed(0)
    jm, tm = _mlp(jpaddle), _mlp(tpaddle)
    load_layer_from_jax(tm, _jax_arrays(jm))
    return jm, tm


def test_parameters_state_dict_and_registries_match(pair):
    jm, tm = pair
    jn = [(n, p.shape, p.stop_gradient) for n, p in jm.named_parameters()]
    tn = [(n, p.shape, p.stop_gradient) for n, p in tm.named_parameters()]
    assert tn == jn
    assert len(tm.parameters()) == len(jm.parameters())
    assert all(isinstance(p, tpaddle.Parameter) for p in tm.parameters())
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [n for n, _ in tm.named_buffers()] == \
        [n for n, _ in jm.named_buffers()]
    assert [n for n, _ in tm.named_sublayers()] == \
        [n for n, _ in jm.named_sublayers()]
    assert [type(s).__name__ for s in tm.sublayers(include_self=True)] == \
        [type(s).__name__ for s in jm.sublayers(include_self=True)]
    assert tm.nothing is None and jm.nothing is None
    assert tm.frozen.stop_gradient and not tm.frozen.trainable
    for name, p in tm.named_parameters():
        assert getattr(tm, name) is p if "." not in name else True
    assert tm.fc1.weight is tm.fc1.weight       # one wrapper while held
    sd = tm.state_dict()
    assert sd["fc1.weight"] is tm.fc1.weight
    assert isinstance(sd["steps"], tpaddle.Tensor)


def test_forward_and_gradients_match(pair):
    jm, tm = pair
    x = np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32)

    def scenario(P):
        m = jm if P is jpaddle else tm
        out = m(P.to_tensor(x))
        out.sum().backward()
        return [out] + [p.grad for _, p in m.named_parameters()
                        if not p.stop_gradient]
    compare(scenario, TOL, TOL)


def test_modes_hooks_apply_and_dtypes(pair):
    def scenario(P):
        m = _mlp(P)
        m.eval()
        ev = [s.training for s in m.sublayers(include_self=True)]
        m.train()
        tr = [s.training for s in m.sublayers(include_self=True)]
        seen = []
        h1 = m.fc1.register_forward_pre_hook(
            lambda layer, inp: (inp[0] * 0.0,))
        h2 = m.head.register_forward_post_hook(
            lambda layer, inp, out: out * 0.0 + 1.0)
        out = m(P.ones([2, 4]))
        h1.remove()
        h2.remove()
        out2 = m(P.zeros([2, 4]))
        m.apply(lambda layer: seen.append(type(layer).__name__))
        m.to(dtype="float16")
        d1 = [str(p.dtype).split(".")[-1] for p in m.parameters()]
        m.astype("float32")
        m.bfloat16()
        d2 = [str(p.dtype).split(".")[-1] for p in m.parameters()]
        return [ev, tr, out, out2.shape, seen == [type(s).__name__ for s in
                                                  m.sublayers(True)],
                d1, d2]
    want, got = scenario(jpaddle), scenario(tpaddle)
    for i, (w, g) in enumerate(zip(want, got)):
        if hasattr(w, "_data"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w._data),
                                       err_msg=str(i))
        else:
            assert g == w, i


def test_set_state_dict_reports_and_casts(pair):
    jm, tm = pair
    for m, P in ((jm, jpaddle), (tm, tpaddle)):
        sd = {"fc1.bias": np.ones(8, np.float32), "bogus": np.zeros(1)}
        missing, unexpected = m.set_state_dict(sd)
        assert unexpected == ["bogus"] and "fc1.weight" in missing
        np.testing.assert_array_equal(m.fc1.bias.numpy(), np.ones(8))
        with pytest.raises(ValueError, match="shape mismatch"):
            m.set_state_dict({"fc1.bias": np.ones(3, np.float32)})
    tm.set_state_dict({"fc1.bias": torch.ones(8, dtype=torch.float64)},
                      cast_dtype=False)
    assert tm.fc1.bias.dtype == torch.float64


def test_containers_match():
    def scenario(P):
        nn = P.nn
        ll = nn.LayerList([nn.Linear(2, 2)])
        ll.append(nn.Linear(2, 3))
        ll.insert(0, nn.Dropout(0.5))
        ll.extend([nn.LayerNorm(3)])
        ld = nn.LayerDict({"a": nn.Linear(2, 2)})
        ld["b"] = nn.Dropout()
        pl = nn.ParameterList([P.create_parameter([2], "float32")])
        pl.append(P.create_parameter([3], "float32"))
        seq = nn.Sequential(OrderedDict([("x", nn.Linear(2, 4)),
                                         ("y", nn.Linear(4, 1))]))
        return [len(ll), [type(l).__name__ for l in ll],
                type(ll[-1]).__name__, len(ll[1:3]), sorted(ld.keys()),
                "a" in ld, len(pl), [p.shape for p in pl],
                [n for n, _ in seq.named_parameters()],
                [n for n, _ in ll.named_parameters()],
                type(seq[1]).__name__, len(seq)]
    assert scenario(tpaddle) == scenario(jpaddle)


# -- the layers and functionals GPT / Llama-style code uses --------------

def _layer_case(build, inputs, call=None):
    return pytest.param(build, inputs, call, id=build.__name__)


def linear(P):
    return P.nn.Linear(4, 3)


def linear_no_bias(P):
    return P.nn.Linear(4, 3, bias_attr=False)


def embedding(P):
    return P.nn.Embedding(10, 4, padding_idx=2)


def layer_norm(P):
    return P.nn.LayerNorm(4, epsilon=1e-5)


def rms_norm(P):
    return P.nn.RMSNorm(4)


def dropout_eval(P):
    d = P.nn.Dropout(0.3)
    d.eval()
    return d


X4 = np.random.default_rng(2).standard_normal((2, 3, 4)).astype(np.float32)
IDS = np.asarray([[1, 2, 3], [2, 9, 0]], np.int64)


@pytest.mark.parametrize("build,inputs,call", [
    _layer_case(linear, [X4]), _layer_case(linear_no_bias, [X4]),
    _layer_case(embedding, [IDS]), _layer_case(layer_norm, [X4]),
    _layer_case(rms_norm, [X4]), _layer_case(dropout_eval, [X4])])
def test_layer_matches_jax(build, inputs, call):
    jpaddle.seed(5)
    jl = build(jpaddle)
    tl = build(tpaddle)
    load_layer_from_jax(tl, _jax_arrays(jl))

    def scenario(P):
        layer = jl if P is jpaddle else tl
        xs = [P.to_tensor(a, stop_gradient=a.dtype.kind != "f")
              for a in inputs]
        out = layer(*xs)
        w = np.random.default_rng(3).standard_normal(
            tuple(out.shape)).astype(np.float32)
        (out * P.to_tensor(w)).sum().backward()
        return [out] + [x.grad for x in xs if not x.stop_gradient] + \
            [p.grad for p in layer.parameters()]
    compare(scenario, TOL, TOL)


@pytest.mark.parametrize("name", ["linear", "embedding", "gelu",
                                  "gelu_tanh", "layer_norm", "rms_norm",
                                  "dropout_p0", "dropout_eval", "sdpa",
                                  "sdpa_causal", "flash_attention",
                                  "cross_entropy", "cross_entropy_3d"])
def test_functional_matches_jax(name):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (4,)).astype(np.float32)
    q = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    kv = rng.standard_normal((2, 2, 6, 2, 8)).astype(np.float32)
    lab = rng.integers(0, 5, (2, 3)).astype(np.int64)
    calls = {
        "linear": ([x, w, b], lambda F, a, c, d: F.linear(a, c, d)),
        "embedding": ([np.int64([[0, 3], [1, 1]]), w],
                      lambda F, i, t: F.embedding(i, t, padding_idx=1)),
        "gelu": ([x], lambda F, a: F.gelu(a)),
        "gelu_tanh": ([x], lambda F, a: F.gelu(a, approximate=True)),
        "layer_norm": ([x, g, b[:4]],
                       lambda F, a, c, d: F.layer_norm(a, 4, c, d)),
        "rms_norm": ([x, g], lambda F, a, c: F.rms_norm(a, c)),
        "dropout_p0": ([x], lambda F, a: F.dropout(a, 0.0)),
        "dropout_eval": ([x], lambda F, a: F.dropout(a, 0.4,
                                                     training=False)),
        "sdpa": ([q, kv[0], kv[1]],
                 lambda F, a, c, d: F.scaled_dot_product_attention(a, c, d)),
        "sdpa_causal": ([q, kv[0], kv[1]],
                        lambda F, a, c, d: F.scaled_dot_product_attention(
                            a, c, d, is_causal=True)),
        "flash_attention": ([q, kv[0], kv[1]],
                            lambda F, a, c, d: F.flash_attention(
                                a, c, d, causal=True)[0]),
        "cross_entropy": ([x.reshape(6, 4), lab.reshape(6) % 4],
                          lambda F, a, i: F.cross_entropy(a, i)),
        "cross_entropy_3d": ([x, lab % 4],
                             lambda F, a, i: F.cross_entropy(
                                 a, i, reduction="sum")),
    }
    inputs, fn = calls[name]

    def scenario(P):
        xs = [P.to_tensor(a, stop_gradient=a.dtype.kind != "f")
              for a in inputs]
        out = fn(P.nn.functional, *xs)
        wt = np.random.default_rng(3).standard_normal(
            tuple(out.shape)).astype(np.float32)
        (out * P.to_tensor(wt)).sum().backward()
        return [out] + [t.grad for t in xs if not t.stop_gradient]
    compare(scenario, 1e-5, 1e-5)


# -- the classes the earlier models hold, from a torch parent -------------

class TorchParent(torch.nn.Module):
    """As BERT and ERNIE-MoE hold them: Layers built with a device and a
    dtype, called with torch tensors."""

    def __init__(self):
        super().__init__()
        kw = dict(device="cpu", dtype=torch.float32)
        self.proj = torch.nn.Linear(8, 8)
        self.ln = tpaddle.nn.LayerNorm(8, 1e-5, **kw)
        self.drop = tpaddle.nn.Dropout(0.0)
        self.attn = GPTAttention(GPTConfig(hidden_size=8,
                                           num_attention_heads=2,
                                           use_flash_attention=True), **kw)
        self.enc = tpaddle.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0,
                                                      activation="gelu",
                                                      **kw)

    def forward(self, x):
        h = self.ln(self.proj(x))
        h = h + self.attn(self.drop(h))
        return self.enc(h)


def test_torch_parent_gets_torch_meanings():
    torch.manual_seed(0)
    m = TorchParent()
    x = torch.randn(2, 5, 8)
    seen = []
    handle = m.ln.register_forward_pre_hook(
        lambda mod, args: seen.append(type(args[0])))
    out = m(x)
    handle.remove()
    assert type(out) is torch.Tensor and seen == [torch.Tensor]
    out.sum().backward()
    # parameters / named_parameters / state_dict of the torch parent
    params = list(m.parameters())
    assert all(type(p) is torch.nn.Parameter for p in params)
    assert all(p.grad is not None for p in params)
    names = [n for n, _ in m.named_parameters()]
    assert "ln.weight" in names and "attn.qkv_proj.weight" in names
    assert "enc.self_attn.q_proj.weight" in names
    sd = m.state_dict()
    assert all(type(v) is torch.Tensor for v in sd.values())
    assert list(sd) == [n for n, _ in m.named_parameters()]
    assert sd["attn.qkv_proj.weight"].shape == (8, 24)     # [in, out]
    # load_state_dict round trip through torch's recursion
    m2 = TorchParent()
    m2.load_state_dict(sd)
    torch.testing.assert_close(m2(x), out)
    # to / train / eval / apply from the torch parent
    m.to(torch.float64)
    assert m.ln._parameters["weight"].dtype == torch.float64
    assert m.attn.qkv_proj._parameters["weight"].dtype == torch.float64
    m.eval()
    assert not m.ln.training and not m.enc.self_attn.training
    m.train()
    visited = []
    m.apply(lambda mod: visited.append(type(mod).__name__))
    assert visited[-1] == "TorchParent" and "LayerNorm" in visited
    assert visited.index("TransformerEncoderLayer") < \
        visited.index("MultiHeadAttention")      # the Layer's own order


def test_layer_methods_keep_paddle_meanings_under_a_layer():
    """The same names called on a Layer: Parameters, paddle state dict,
    paddle ``to`` and pre-order ``apply``."""
    ln = tpaddle.nn.LayerNorm(4)
    assert all(isinstance(p, tpaddle.Parameter) for p in ln.parameters())
    assert [n for n, _ in ln.named_parameters()] == ["weight", "bias"]
    assert all(isinstance(v, tpaddle.Parameter)
               for v in ln.state_dict().values())
    assert list(ln.state_dict(structured_name_prefix="a.")) == \
        ["a.weight", "a.bias"]
    raw = ln.state_dict(prefix="p.", keep_vars=False)    # torch's
    assert list(raw) == ["p.weight", "p.bias"]
    assert all(type(v) is torch.Tensor for v in raw.values())
    ln.to("cpu", "float64")
    assert ln.weight.dtype == torch.float64 and ln._dtype == torch.float64
    ln.to(torch.float32)
    assert ln.bias.dtype == torch.float32
    enc = tpaddle.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0,
                                             activation="gelu", device="cpu")
    order = []
    enc.apply(lambda mod: order.append(type(mod).__name__))
    assert order[0] == "TransformerEncoderLayer"


def test_earlier_layers_take_and_return_tensors():
    """LayerNorm, Dropout, GPTAttention, MultiHeadAttention,
    TransformerEncoder and CrossEntropyLoss called with Tensors return
    Tensors, and the gradients reach their Parameters."""
    nn = tpaddle.nn
    x = tpaddle.to_tensor(np.random.default_rng(0).standard_normal(
        (2, 5, 8)).astype(np.float32), stop_gradient=False)
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        8, 2, 16, dropout=0.0, activation="gelu", device="cpu"), 2)
    mha = nn.MultiHeadAttention(8, 2, device="cpu")
    attn = GPTAttention(GPTConfig(hidden_size=8, num_attention_heads=2))
    ln, drop = nn.LayerNorm(8), nn.Dropout(0.0)
    h = enc(drop(ln(x)))
    h = h + mha(h) + attn(h)
    assert isinstance(h, tpaddle.Tensor) and h.shape == [2, 5, 8]
    loss = nn.CrossEntropyLoss()(h.reshape([-1, 8]),
                                 tpaddle.to_tensor(np.arange(10) % 8))
    assert isinstance(loss, tpaddle.Tensor) and loss.shape == []
    loss.backward()
    assert x.grad is not None and ln.weight.grad is not None
    assert attn.qkv_proj.weight.grad is not None
    assert all(p.grad is not None for p in enc.parameters())
    assert all(isinstance(p, tpaddle.Parameter) for p in enc.parameters())


def test_optimizer_takes_parameters_with_and_without_names():
    """``optimizer.AdamW`` over a Layer's Parameters keeps the
    ``torch.nn.Parameter`` each wraps, names them by ``Parameter.name``
    (else ``param_{i}``) or by the pairs of ``named_parameters()``, and
    its fused step writes the layer's own parameters."""
    lin = tpaddle.nn.Linear(3, 2, weight_attr=tpaddle.nn.ParamAttr(
        name="proj.w"))
    opt = tpaddle.optimizer.AdamW(learning_rate=0.1,
                                  parameters=lin.parameters())
    assert opt._param_names == ["proj.w", "param_1"]
    assert opt._parameter_list[0] is lin._parameters["weight"]
    named = tpaddle.optimizer.AdamW(learning_rate=0.1,
                                    parameters=lin.named_parameters())
    assert named._param_names == ["weight", "bias"]
    before = lin.weight.numpy().copy()
    lin(tpaddle.ones([4, 3])).sum().backward()
    named.step()
    assert not np.array_equal(lin.weight.numpy(), before)
