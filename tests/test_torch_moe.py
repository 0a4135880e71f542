"""The port's MoE slice against the JAX package's, on the CPU.

The same numpy inputs and the same weights (copied through
``convert``) go through the JAX functions and layers and the port's:
the capacity dispatch tables, the dense dispatch algebra, the index
forward, ``MoELayer`` in each dispatch mode (output, aux loss and
gradients), and a tiny ERNIE-MoE (logits, then three AdamW
``TrainStep``s with the causal-LM loss plus the aux loss, as
``tests/test_moe.py`` trains it). f32 with TF32 off. Routing is
discrete: the inputs are chosen so that no token's first three gate
probabilities lie within 1e-4 of each other, and the routing tables are
asserted equal before any number is compared, so that a near-tie cannot
pass as a tolerance problem. Tolerances are the training slice's f32
ones (``tests/test_torch_train.py``); integers exactly, weights and aux
losses within 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate import moe_dispatch as jdispatch
from paddle_tpu.incubate.moe import MoELayer as JaxMoELayer
from paddle_tpu.incubate.moe import _gshard_dispatch as jax_gshard
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
from paddle_tpu.jit.api import functionalize
from paddle_tpu.models import ErnieMoEConfig as JaxConfig
from paddle_tpu.models import ErnieMoEForCausalLM as JaxErnie
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu_torch.convert import (linear_weight_names, load_from_jax,
                                      optimizer_state_from_jax)
from paddle_tpu_torch.incubate import moe_dispatch as tdispatch
from paddle_tpu_torch.incubate.moe import MoELayer, _gshard_dispatch
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.ernie_moe import (ErnieMoEConfig,
                                               ErnieMoEForCausalLM)
from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
from paddle_tpu_torch.optimizer import AdamW

LR, STEPS = 1e-3, 3
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
PARAM_CLOSE, PARAM_CLOSE_SHARE = 1e-5, 0.99
MARGIN = 1e-4
# the JAX functions under jit: one compile each instead of one per op
jax_tables = jax.jit(jdispatch.capacity_dispatch_indices,
                     static_argnums=(1, 2))
jax_gshard_jit = jax.jit(jax_gshard, static_argnums=(1, 2))
jax_moe_forward = jax.jit(jdispatch.moe_forward_indices,
                          static_argnums=(4, 5, 6))


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _margin(logits: np.ndarray) -> float:
    """The least gap between a token's first, second and third gate
    probabilities."""
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))
    top = -np.sort(-p, axis=-1)[:, :3]
    return float(np.diff(-top, axis=-1).min())


def _tables_equal(got, want):
    """``capacity_dispatch_indices`` outputs: integers and the occupancy
    exactly, weights and aux within 1e-6."""
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got[5].item(), float(want[5]), rtol=1e-6)


def _logits(t, e, seed):
    logits = 2 * np.random.default_rng(seed).standard_normal(
        (t, e)).astype(np.float32)
    assert _margin(logits) > MARGIN
    return logits


@pytest.mark.parametrize("top_k,cap", [(2, 12), (1, 40), (2, 100)],
                         ids=["top2-drops", "top1", "top2-ample"])
def test_capacity_dispatch_tables_equal_jax(top_k, cap):
    logits = _logits(48, 4, seed=2)
    want = jax_tables(jnp.asarray(logits), top_k, cap)
    got = tdispatch.capacity_dispatch_indices(torch.from_numpy(logits),
                                              top_k, cap)
    _tables_equal(got, want)
    if cap == 12:
        assert not bool(got[1].all()) or bool((got[4] == 0).any())


def test_gshard_dispatch_equals_jax():
    logits = _logits(32, 4, seed=2)
    want = jax_gshard_jit(jnp.asarray(logits), 2, 12)
    got = _gshard_dispatch(torch.from_numpy(logits), 2, 12)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-6)
    np.testing.assert_allclose(got[2].item(), float(want[2]), rtol=1e-6)


def _jax_value_and_grads(layer, fn, *inputs):
    """``fn(*inputs) -> (loss, aux)`` through ``layer`` as one jitted
    ``jax.value_and_grad`` over the layer's parameters and the float
    inputs (the JAX package's ``functionalize``; one compile where the
    eager tape compiles every op). -> ``(loss, aux, param grads, input
    grads)`` as numpy."""
    apply, params, buffers = functionalize(layer, fn)
    floats = tuple(i for i, a in enumerate(inputs)
                   if np.issubdtype(np.asarray(a).dtype, np.floating))

    def loss_of(p, *args):
        return apply(p, buffers, *args)[0]

    grad_fn = jax.jit(jax.value_and_grad(
        loss_of, argnums=(0,) + tuple(i + 1 for i in floats), has_aux=True))
    (loss, aux), grads = grad_fn(params, *map(jnp.asarray, inputs))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return float(loss), to_np(aux), to_np(grads[0]), to_np(grads[1:])


def _jax_layer(h, f, e, seed, **kw):
    paddle.seed(seed)
    jm = JaxMoELayer(h, f, e, **kw)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = MoELayer(h, f, e, **kw)
    load_from_jax(tm, arrays)
    return jm, tm, arrays


def test_moe_forward_indices_matches_jax():
    h, f, e, t = 16, 32, 4, 40
    _, _, arrays = _jax_layer(h, f, e, seed=3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((t, h)).astype(np.float32)
    assert _margin(x @ arrays["gate.weight"]) > MARGIN
    args = [arrays[n] for n in ("gate.weight", "w_in", "w_out")]
    want, want_aux = jax_moe_forward(
        jnp.asarray(x), *map(jnp.asarray, args), 2, 20, jax.nn.gelu)
    got, aux = tdispatch.moe_forward_indices(
        torch.from_numpy(x), *map(torch.tensor, args), 2, 20,
        lambda v: torch.nn.functional.gelu(v, approximate="tanh"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("mode,gate", [("index", "gshard"),
                                       ("dense", "naive"),
                                       ("auto", "switch")])
def test_moe_layer_matches_jax(mode, gate):
    """Output, aux loss and the gradients of x, the gate and both expert
    stacks, against the JAX layer with the same weights; capacity
    factor 1.0 so that some choices are dropped."""
    h, f, e = 16, 32, 4
    kw = dict(gate=gate, capacity_factor=1.0, dispatch_mode=mode)
    jm, tm, arrays = _jax_layer(h, f, e, seed=4, **kw)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 20, h)).astype(np.float32)
    dy = rng.standard_normal((2, 20, h)).astype(np.float32)
    assert _margin(x.reshape(-1, h) @ arrays["gate.weight"]) > MARGIN

    def fn(xt):
        y = jm(xt)
        return (y * paddle.to_tensor(dy)).sum(), (y, jm.aux_loss)

    _, (jy, jaux), jgrads, (jxg,) = _jax_value_and_grads(jm, fn, x)
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm(tx)
    (ty * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tm.aux_loss.item(), float(jaux), rtol=1e-6)
    assert 0.0 < tm.drop_share.item() < 0.5
    grads = {"x": (tx.grad, jxg)}
    grads.update({n: (p.grad, jgrads[n]) for n, p in tm.named_parameters()})
    for name, (g, ref) in grads.items():
        err = np.abs(g.numpy() - ref)
        assert (err <= GRAD_ATOL + GRAD_RTOL * np.abs(ref)).all(), \
            (name, float(err.max()))


# -- the slice as a whole: a tiny ERNIE-MoE ----------------------------------

def _ids():
    return np.random.default_rng(0).integers(0, 128, (2, 24)).astype(
        np.int32)


def _jax_moe_input(jm, ids):
    """The hidden states entering the JAX model's MoE layer (block 1)."""
    pos = paddle.to_tensor(np.arange(ids.shape[1], dtype=np.int32)[None])
    h = jm.wte(ids) + jm.wpe(pos)
    h = jm.blocks[0](h)
    blk = jm.blocks[1]
    h = h + blk.attn(blk.ln_1(h))
    return blk.ln_2(h)


def _port_moe_input(tm, ids):
    seen = {}
    handle = tm.blocks[1].moe.register_forward_pre_hook(
        lambda mod, args: seen.update(x=args[0].detach()))
    tm(torch.from_numpy(ids).long())
    handle.remove()
    return seen["x"].reshape(-1, seen["x"].shape[-1])


@pytest.fixture(scope="module")
def pair():
    """One tiny ERNIE-MoE on each side from the same weights; one forward
    and backward of the LM loss plus the aux loss on each."""
    paddle.seed(21)
    jm = JaxErnie(JaxConfig.tiny())
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = ErnieMoEForCausalLM(ErnieMoEConfig.tiny(), device="cpu")
    load_from_jax(tm, arrays)
    ids = _ids()

    def fn(ids_t):
        logits = jm(ids_t)
        aux = jm.total_aux_loss()
        loss = JaxCriterion()(logits, ids_t) + aux
        return loss, (logits, aux, _jax_moe_input(jm, ids_t))

    jloss, (jlogits, jaux, jmoe_in), jgrads, _ = _jax_value_and_grads(
        jm, fn, ids)
    tids = torch.from_numpy(ids).long()
    tlogits = tm(tids)
    taux = tm.total_aux_loss().item()
    tloss = LlamaPretrainingCriterion()(tlogits, tids) + tm.total_aux_loss()
    tloss.backward()
    return dict(tm=tm, arrays=arrays, ids=ids, jlogits=jlogits,
                tlogits=tlogits.detach(), jaux=float(jaux), taux=taux,
                jloss=jloss, tloss=tloss.item(), jgrads=jgrads,
                jmoe_in=jmoe_in)


def test_tiny_ernie_routes_and_logits_match_jax(pair):
    tm, arrays, ids = pair["tm"], pair["arrays"], pair["ids"]
    gate = arrays["blocks.1.moe.gate.weight"]
    jx = pair["jmoe_in"].reshape(-1, gate.shape[0])
    tx = _port_moe_input(tm, ids)
    assert _margin(jx @ gate) > MARGIN
    cap = int(1.25 * ids.size * 2 / 4)
    _tables_equal(
        tdispatch.capacity_dispatch_indices(tx @ torch.tensor(gate), 2,
                                            cap),
        jax_tables(jnp.asarray(jx @ gate), 2, cap))
    assert pair["tlogits"].shape == (2, 24, 128)
    np.testing.assert_allclose(pair["tlogits"].numpy(), pair["jlogits"],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pair["taux"], pair["jaux"], rtol=1e-6)


def test_first_step_gradients_match_jax(pair):
    tm = pair["tm"]
    np.testing.assert_allclose(pair["tloss"], pair["jloss"], rtol=LOSS_RTOL)
    for name, p in tm.named_parameters():
        ref = _port_layout(tm, name, pair["jgrads"][name])
        err = np.abs(p.grad.numpy() - ref)
        assert (err <= GRAD_ATOL + GRAD_RTOL * np.abs(ref)).all(), \
            (name, float(err.max()))


def test_convert_copies_expert_stacks_and_gate_untransposed(pair):
    tm, arrays = pair["tm"], pair["arrays"]
    lin = linear_weight_names(tm)
    assert "blocks.1.moe.gate.weight" not in lin
    # the attention's projections are paddle Linears ([in, out], as in
    # the JAX model): copied as they are, like the expert stacks
    assert "blocks.0.attn.qkv_proj.weight" not in lin
    assert {"lm_head.weight", "blocks.0.fc_in.weight"} <= lin
    sd = tm.state_dict()
    assert set(sd) == set(arrays)
    for n in ("blocks.1.moe.w_in", "blocks.1.moe.w_out",
              "blocks.1.moe.gate.weight", "blocks.0.attn.qkv_proj.weight"):
        np.testing.assert_array_equal(sd[n].numpy(), arrays[n])


def _port_layout(tm, name, a):
    a = np.asarray(a)
    return a.T if name in linear_weight_names(tm) else a


@pytest.fixture(scope="module")
def trained():
    paddle.seed(21)
    jm = JaxErnie(JaxConfig.tiny())
    tm = ErnieMoEForCausalLM(ErnieMoEConfig.tiny(), device="cpu")
    load_from_jax(tm, {n: np.asarray(p._data)
                       for n, p in jm.named_parameters()})
    ids = _ids()
    tids = torch.from_numpy(ids).long()
    jcrit, tcrit = JaxCriterion(), LlamaPretrainingCriterion()

    def jloss(lg, lb):
        return jcrit(lg, lb) + jm.total_aux_loss()

    def tloss(lg, lb):
        return tcrit(lg, lb) + tm.total_aux_loss()

    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters(),
                                  multi_precision=False)
    topt = AdamW(learning_rate=LR, parameters=tm.named_parameters(),
                 multi_precision=False)
    jstep = JaxTrainStep(jm, jloss, jopt)
    tstep = TrainStep(tm, tloss, topt)
    jl, tl, taux = [], [], []
    for _ in range(STEPS):
        jl.append(float(jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))))
        tl.append(tstep(tids, tids).item())
        # the aux loss of the step's forward (the weights before it); the
        # JAX step is traced, so its aux loss is compared after training,
        # from eager forwards on both sides
        taux.append(tm.total_aux_loss().item())
    return dict(jm=jm, tm=tm, jopt=jopt, jl=jl, tl=tl, taux=taux, ids=ids)


def test_train_steps_track_jax_losses(trained):
    t = trained
    np.testing.assert_allclose(t["tl"], t["jl"], rtol=LOSS_RTOL)
    assert t["jl"][-1] < t["jl"][0]
    assert all(a > 0 for a in t["taux"])


def test_parameters_after_three_steps_match_jax(trained):
    """AdamW turns a sign flip of a near-zero gradient into a whole lr
    step, so: 99 % of the elements within 1e-5, all within
    3 * lr * steps; then the aux loss of the trained weights."""
    t = trained
    tparams = dict(t["tm"].named_parameters())
    n_close = n_all = 0
    for name, p in t["jm"].named_parameters():
        ref = _port_layout(t["tm"], name, p._data)
        err = np.abs(tparams[name].detach().numpy() - ref)
        assert err.max() <= 3 * LR * STEPS, (name, float(err.max()))
        n_close += int((err <= PARAM_CLOSE).sum())
        n_all += err.size
    assert n_close >= PARAM_CLOSE_SHARE * n_all, n_close / n_all
    jm = t["jm"]
    apply, params, buffers = functionalize(
        jm, lambda ids_t: (jm(ids_t), jm.total_aux_loss()))
    # the JAX MoE layer keeps its last aux loss as a buffer, which the
    # traced train step leaves holding a tracer; the forward rewrites it
    buffers = {k: jnp.zeros(jnp.shape(v), v.dtype) for k, v in
               buffers.items()}
    (_, jaux), _ = jax.jit(apply)(params, buffers, jnp.asarray(t["ids"]))
    t["tm"](torch.from_numpy(t["ids"]).long())
    np.testing.assert_allclose(t["tm"].total_aux_loss().item(), float(jaux),
                               rtol=1e-5)


def test_convert_carries_the_jax_adamw_state(trained):
    """The JAX AdamW slots after three steps, by parameter name: the
    moments of Linear weights transposed like the weights, those of the
    expert stacks and the gate as they are."""
    t = trained
    jstates = {n: {k: np.asarray(getattr(v, "_data", v)) for k, v in
                   t["jopt"]._states[id(p)].items()}
               for n, p in t["jm"].named_parameters()}
    opt = AdamW(learning_rate=LR, parameters=t["tm"].named_parameters(),
                multi_precision=False)
    opt.set_named_states(optimizer_state_from_jax(jstates, t["tm"]))
    back = opt.named_states()
    assert set(back) == set(jstates)
    for name, slots in jstates.items():
        for k, a in slots.items():
            np.testing.assert_array_equal(
                _port_layout(t["tm"], name, back[name][k].numpy()), a)
    assert back["blocks.1.moe.w_in"]["moment1"].shape == (4, 64, 128)
    assert back["blocks.1.moe.gate.weight"]["moment2"].shape == (64, 4)
