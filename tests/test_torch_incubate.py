"""The rest of the port's ``incubate`` and its ``geometric`` against the
JAX package's, function by function, on the CPU: the five fused layers
(pre- and post-norm, forward within 1e-5 and one backward within 1e-4,
dropout 0; the JAX parameters loaded key for key), ASP (the three mask
algorithms, the checks, ``prune_model`` and a ``decorate``d AdamW that
keeps the masks), ``LookAhead`` and ``ModelAverage`` over SGD,
``softmax_mask_fuse`` / ``_upper_triangle``, ``identity_loss``, the
segment reductions and message passing (values and gradients), the
reindexing, the neighbour samplers (whole neighbourhoods compared;
subsampling by its properties and its seed) and the ``graph_*`` names.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.geometric as jgeo
import paddle_tpu.incubate as jinc
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.geometric as tgeo
import paddle_tpu_torch.incubate as tinc
from paddle_tpu.jit.api import functionalize
from paddle_tpu_torch.convert import state_dict_from_jax
from test_torch_tensor import port_on_cpu  # noqa: F401

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.abs(got - want) <= tol * (1 + np.abs(want))), \
        (what, float(np.abs(got - want).max()))


def _np(t):
    return t.numpy() if hasattr(t, "numpy") else np.asarray(t)


# -- the fused layers ----------------------------------------------------------

def _fused(P, kind, pre):
    N = P.incubate.nn
    if kind == "mha":
        return N.FusedMultiHeadAttention(32, 4, dropout_rate=0.0,
                                         attn_dropout_rate=0.0,
                                         normalize_before=pre)
    if kind == "ffn":
        return N.FusedFeedForward(32, 64, dropout_rate=0.0,
                                  activation="gelu", normalize_before=pre)
    return N.FusedTransformerEncoderLayer(32, 4, 64, dropout_rate=0.0,
                                          activation="relu",
                                          normalize_before=pre)


@pytest.mark.parametrize("pre", [False, True], ids=["post_norm", "pre_norm"])
@pytest.mark.parametrize("kind", ["mha", "ffn", "encoder"])
def test_fused_layer_matches_jax(kind, pre):
    jpaddle.seed(1)
    jl = _fused(jpaddle, kind, pre)
    tl = _fused(tpaddle, kind, pre)
    arrays = {n: np.asarray(p._data) for n, p in jl.named_parameters()}
    sd = state_dict_from_jax(arrays, model=tl)
    assert set(sd) == set(tl.state_dict())
    tl.load_state_dict(sd)
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 16, 32)).astype(np.float32)
    w = r.standard_normal((2, 16, 32)).astype(np.float32)
    fwd, params, buffers = functionalize(jl)
    out, vjp = jax.vjp(lambda p, a: fwd(p, buffers, a)[0], params,
                       jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    got = tl(tx)
    _close(got.detach().numpy(), np.asarray(out), FWD_TOL, "out")
    names = [n for n, _ in torch.nn.Module.named_parameters(tl)]
    leaves = [p for _, p in torch.nn.Module.named_parameters(tl)]
    grads = torch.autograd.grad(got, [tx] + leaves, torch.from_numpy(w))
    _close(grads[0].numpy(), np.asarray(gx), GRAD_TOL, "dx")
    for n, g in zip(names, grads[1:]):
        _close(g.numpy(), np.asarray(gp[n]), GRAD_TOL, n)


def test_fused_encoder_ignores_cache_and_takes_a_mask():
    tpaddle.seed(0)
    layer = _fused(tpaddle, "encoder", False)
    x = tpaddle.to_tensor(np.ones((1, 4, 32), np.float32))
    a = layer(x).numpy()
    np.testing.assert_array_equal(layer(x, cache=object()).numpy(), a)
    mask = tpaddle.to_tensor(np.zeros((1, 1, 4, 4), np.float32))
    np.testing.assert_allclose(layer(x, src_mask=mask).numpy(), a,
                               atol=1e-6)


def test_fused_linear_and_dropout_add_match_jax():
    jpaddle.seed(4)
    jl = jinc.nn.FusedLinear(8, 4)
    tl = tinc.nn.FusedLinear(8, 4)
    tl.load_state_dict(state_dict_from_jax(
        {n: np.asarray(p._data) for n, p in jl.named_parameters()},
        model=tl))
    x = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    _close(_np(tl(tpaddle.to_tensor(x))), _np(jl(jpaddle.to_tensor(x))),
           FWD_TOL)
    jd, td = jinc.nn.FusedDropoutAdd(0.5), tinc.nn.FusedDropoutAdd(0.5)
    jd.eval()
    td.eval()
    y = x[::-1].copy()
    _close(_np(td(tpaddle.to_tensor(x), tpaddle.to_tensor(y))),
           _np(jd(jpaddle.to_tensor(x), jpaddle.to_tensor(y))), 0)
    with pytest.raises(ValueError, match="must divide"):
        tinc.nn.FusedMultiHeadAttention(30, 4)


# -- ASP -----------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["mask_1d", "mask_2d_greedy",
                                  "mask_2d_best"])
def test_asp_masks_and_checks_match_jax(algo):
    w = np.random.default_rng(3).standard_normal((10, 12)).astype(
        np.float32)
    got = tinc.asp.create_mask(torch.from_numpy(w), algo)
    want = jinc.asp.create_mask(w, algo)
    np.testing.assert_array_equal(got, want)
    masked = w * want
    for fn in ("check_1d", "check_2d", "mask_1d", "mask_2d_best"):
        assert tinc.asp.check_sparsity(masked, func_name=fn) == \
            jinc.asp.check_sparsity(masked, func_name=fn)
    assert tinc.asp.check_mask_2d(masked) == jinc.asp.check_mask_2d(masked)
    assert tinc.asp.calculate_density(torch.from_numpy(masked)) == \
        jinc.asp.calculate_density(masked)
    with pytest.raises(NotImplementedError):
        tinc.asp.create_mask(w, "mask_3d")


def _asp_pair(P):
    P.seed(7)
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                           P.nn.Linear(16, 4))


def test_asp_prune_and_decorated_adamw_match_jax():
    jm = _asp_pair(jpaddle)
    tm = _asp_pair(tpaddle)
    tm.load_state_dict(state_dict_from_jax(
        {n: np.asarray(p._data) for n, p in jm.named_parameters()},
        model=tm))
    jinc.asp.reset_excluded_layers()
    tinc.asp.reset_excluded_layers()
    tinc.asp.set_excluded_layers(["2"])
    jinc.asp.set_excluded_layers(["2"])
    try:
        jmasks = jinc.asp.prune_model(jm)
        tmasks = tinc.asp.prune_model(tm)
    finally:
        jinc.asp.reset_excluded_layers()
        tinc.asp.reset_excluded_layers()
    assert sorted(tmasks) == sorted(jmasks) == ["0.weight"]
    np.testing.assert_array_equal(tmasks["0.weight"].numpy(),
                                  np.asarray(jmasks["0.weight"]))
    jopt = jinc.asp.decorate(jpaddle.optimizer.AdamW(
        learning_rate=0.05, parameters=jm.parameters()))
    topt = tinc.asp.decorate(tpaddle.optimizer.AdamW(
        learning_rate=0.05, parameters=tm.parameters()))
    x = np.random.default_rng(1).standard_normal((6, 8)).astype(np.float32)
    for _ in range(2):
        for P, m, opt in ((jpaddle, jm, jopt), (tpaddle, tm, topt)):
            loss = (m(P.to_tensor(x)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
    for (n, jp), tp in zip(jm.named_parameters(), tm.parameters()):
        _close(_np(tp), np.asarray(jp._data), 1e-5, n)
    assert tinc.asp.check_sparsity(tm[0].weight)
    assert (tm[0].weight.numpy()[tmasks["0.weight"].numpy() == 0] == 0).all()


# -- LookAhead, ModelAverage ---------------------------------------------------

def _linear_run(P, wrap, steps=4):
    P.seed(0)
    mdl = P.nn.Linear(4, 4)
    if P is tpaddle:          # the JAX layer's weights (seed 0)
        jpaddle.seed(0)
        jl = jpaddle.nn.Linear(4, 4)
        mdl.load_state_dict(state_dict_from_jax(
            {n: np.asarray(p._data) for n, p in jl.named_parameters()},
            model=mdl))
    opt = P.optimizer.SGD(learning_rate=0.1, parameters=mdl.parameters())
    X = P.to_tensor(np.random.default_rng(5).standard_normal((8, 4))
                    .astype(np.float32))
    return wrap(P, mdl, opt, X, steps)


def _lookahead(P, mdl, opt, X, steps):
    inc = P.incubate
    la = inc.LookAhead(opt, alpha=0.5, k=2)
    out = []
    for _ in range(steps):
        loss = (mdl(X) ** 2).mean()
        loss.backward()
        la.step()
        la.clear_grad()
        out.append(mdl.weight.numpy().copy())
    return out, la.state_dict()["step_count"]


def _model_average(P, mdl, opt, X, steps):
    ma = P.incubate.ModelAverage(0.5, parameters=mdl.parameters(),
                                 min_average_window=2,
                                 max_average_window=3)
    for _ in range(steps):
        loss = (mdl(X) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        ma.step()
    trained = mdl.weight.numpy().copy()
    with ma.apply():
        applied = mdl.weight.numpy().copy()
    return trained, applied, mdl.weight.numpy().copy()


def test_lookahead_and_model_average_match_jax():
    jw, jn = _linear_run(jpaddle, _lookahead)
    tw, tn = _linear_run(tpaddle, _lookahead)
    assert jn == tn == 4
    for a, b in zip(tw, jw):
        _close(a, b, 1e-6)
    j = _linear_run(jpaddle, _model_average)
    t = _linear_run(tpaddle, _model_average)
    for a, b in zip(t, j):
        _close(a, b, 1e-6)
    np.testing.assert_array_equal(t[2], t[0])       # restored
    with pytest.raises(ValueError):
        tinc.LookAhead(None, alpha=2.0)


def test_masked_softmax_and_identity_loss_match_jax():
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 3, 4, 6)).astype(np.float32)
    m = np.where(r.random((2, 3, 4, 6)) < 0.3, -1e4, 0.0).astype(np.float32)
    _close(_np(tinc.softmax_mask_fuse(tpaddle.to_tensor(x),
                                      tpaddle.to_tensor(m))),
           _np(jinc.softmax_mask_fuse(jpaddle.to_tensor(x),
                                      jpaddle.to_tensor(m))), FWD_TOL)
    _close(_np(tinc.softmax_mask_fuse_upper_triangle(tpaddle.to_tensor(x))),
           _np(jinc.softmax_mask_fuse_upper_triangle(jpaddle.to_tensor(x))),
           FWD_TOL)
    for red in ("mean", "sum", "none", 0, 1, 2):
        _close(_np(tinc.identity_loss(tpaddle.to_tensor(x), red)),
               _np(jinc.identity_loss(jpaddle.to_tensor(x), red)), FWD_TOL)
    with pytest.raises(ValueError):
        tinc.identity_loss(tpaddle.to_tensor(x), "max")


# -- geometric and the graph_* names --------------------------------------------

IDS = np.array([0, 0, 1, 3, 3, 3], np.int64)       # segment 2 is empty


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean",
                                "segment_max", "segment_min"])
def test_segment_ops_match_jax(op):
    d = np.random.default_rng(8).standard_normal((6, 3)).astype(np.float32)
    w = np.random.default_rng(9).standard_normal((4, 3)).astype(np.float32)
    x = tpaddle.to_tensor(d, stop_gradient=False)
    got = getattr(tgeo, op)(x, tpaddle.to_tensor(IDS))
    (got * tpaddle.to_tensor(w)).sum().backward()
    jx = jpaddle.to_tensor(d, stop_gradient=False)
    want = getattr(jgeo, op)(jx, jpaddle.to_tensor(IDS))
    (want * jpaddle.to_tensor(w)).sum().backward()
    _close(got.numpy(), want.numpy(), FWD_TOL, op)
    _close(x.grad.numpy(), jx.grad.numpy(), GRAD_TOL, op + " grad")
    # the incubate names are the same functions
    assert getattr(tinc, op) is getattr(tgeo, op)
    n = getattr(tgeo, op)(tpaddle.to_tensor(d), tpaddle.to_tensor(IDS),
                          num_segments=6)
    assert n.shape == [6, 3]


GRAPH_X = np.random.default_rng(10).standard_normal((5, 3)).astype(
    np.float32)
SRC = np.array([0, 1, 2, 3, 4, 0, 2], np.int64)
DST = np.array([1, 2, 0, 0, 1, 3, 3], np.int64)


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_message_passing_matches_jax(reduce_op):
    def run(P, G, inc):
        x = P.to_tensor(GRAPH_X)
        e = P.to_tensor(np.linspace(0.5, 2.0, 21).reshape(7, 3)
                        .astype(np.float32))
        s, d = P.to_tensor(SRC), P.to_tensor(DST)
        return [G.send_u_recv(x, s, d, reduce_op).numpy(),
                G.send_u_recv(x, s, d, reduce_op, out_size=4).numpy(),
                G.send_ue_recv(x, e, s, d, "mul", reduce_op).numpy(),
                G.send_ue_recv(x, e, s, d, "sub", reduce_op).numpy(),
                G.send_uv(x, x, s, d, "div").numpy(),
                inc.graph_send_recv(x, s, d, pool_type=reduce_op).numpy()]
    for a, b in zip(run(tpaddle, tgeo, tinc), run(jpaddle, jgeo, jinc)):
        _close(a, b, FWD_TOL, reduce_op)
    with pytest.raises(ValueError):
        tgeo.send_u_recv(tpaddle.to_tensor(GRAPH_X), tpaddle.to_tensor(SRC),
                         tpaddle.to_tensor(DST), "prod")


# a CSC graph of 6 nodes: the in-neighbours of node j are
# row[colptr[j]:colptr[j + 1]]
ROW = np.array([1, 2, 3, 0, 4, 5, 1, 2, 0, 3, 5, 4], np.int64)
COLPTR = np.array([0, 3, 5, 6, 8, 10, 12], np.int64)


def _graph_ops(P, G, inc):
    row, colptr = P.to_tensor(ROW), P.to_tensor(COLPTR)
    nodes = P.to_tensor(np.array([0, 3, 4], np.int64))
    eids = P.to_tensor(np.arange(12, dtype=np.int64) + 100)
    w = P.to_tensor(np.linspace(0.1, 1.2, 12).astype(np.float32))
    out = [G.reindex_graph(nodes, P.to_tensor(np.array([5, 1, 7, 3, 5])),
                           P.to_tensor(np.array([2, 1, 2])))]
    out.append(G.reindex_heter_graph(
        nodes, [P.to_tensor(np.array([5, 1])), P.to_tensor(np.array([9]))],
        [P.to_tensor(np.array([1, 1, 0])), P.to_tensor(np.array([0, 0, 1]))]))
    out.append(G.sample_neighbors(row, colptr, nodes, eids=eids,
                                  return_eids=True))
    out.append(G.weighted_sample_neighbors(row, colptr, w, nodes))
    out.append(inc.graph_sample_neighbors(row, colptr, nodes, eids,
                                          None, -1, True))
    out.append(inc.graph_reindex(nodes, P.to_tensor(np.array([5, 1, 7])),
                                 P.to_tensor(np.array([1, 1, 1]))))
    out.append(inc.graph_khop_sampler(row, colptr, nodes, [-1, -1]))
    return [[np.asarray(t.numpy()) for t in res] for res in out]


def test_graph_ops_match_jax():
    got = _graph_ops(tpaddle, tgeo, tinc)
    want = _graph_ops(jpaddle, jgeo, jinc)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), i
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b, err_msg=str(i))


def test_subsampling_keeps_its_properties_and_its_seed():
    row, colptr = tpaddle.to_tensor(ROW), tpaddle.to_tensor(COLPTR)
    nodes = tpaddle.to_tensor(np.array([0, 3, 4, 5], np.int64))
    runs = []
    for _ in range(2):
        tpaddle.seed(3)
        neigh, cnt = tgeo.sample_neighbors(row, colptr, nodes, sample_size=1)
        runs.append((neigh.numpy(), cnt.numpy()))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    neigh, cnt = runs[0]
    np.testing.assert_array_equal(cnt, [1, 1, 1, 1])
    for v, n in zip(neigh, [0, 3, 4, 5]):
        assert v in ROW[COLPTR[n]:COLPTR[n + 1]]
    with pytest.raises(ValueError, match="needs eids"):
        tgeo.sample_neighbors(row, colptr, nodes, return_eids=True)
