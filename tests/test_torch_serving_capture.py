"""The serving step as a pure device program: the port's device write
plan and its engine bodies against the JAX package's, and
``capture_jit``'s accounting on the CPU.

Both engines hold the same tiny f32 Llama (weights carried across with
``convert.load_from_jax``); pools, block tables and positions are drawn
with numpy from a seed and copied into both. Each port body
(``_decode_impl``, ``_prefill_impl`` at every bucket edge,
``_propose_impl``, ``_spec_verify_impl``, the copy-on-write program, and
the dense engine's decode and prefill) runs on the same inputs as the
JAX body (jitted): tokens equal, pools and logits within 1e-5 (1 +
|ref|). The port's pools are the leading blocks of stores with one more
block, the sink the write plan sends dropped rows to; the sink is
compared apart."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import LlamaDecodeEngine as JaxDense
from paddle_tpu.serving import PagedLlamaDecodeEngine as JaxPaged
from paddle_tpu_torch import serving_cache as tsc
from paddle_tpu_torch.convert import load_from_jax
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.jit import sot as tsot
from paddle_tpu_torch.jit import warmup as twarmup
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import flight
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.serving import LlamaDecodeEngine, PagedLlamaDecodeEngine
from test_torch_tensor import port_on_cpu  # noqa: F401

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, use_flash_attention=False)
GEO = dict(max_slots=3, max_seq=64, block_size=4, prefill_chunk=16,
           num_blocks=52)
S, NB, BS, MB = 3, 52, 4, 16
TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JaxLlama(JaxConfig.tiny(**CFG))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_from_jax(tm, {k: np.asarray(v._data)
                       for k, v in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def engines(models):
    jm, tm = models
    return JaxPaged(jm, **GEO), PagedLlamaDecodeEngine(tm, device="cpu",
                                                       **GEO)


def close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.abs(got - want) > TOL * (1 + np.abs(want))
    assert not bad.any(), (what, float(np.abs(got - want).max()))


def state(seed, quant=None):
    """Pools, tables (some entries unmapped), positions, active flags
    and last tokens drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    kvh, D = CFG["num_key_value_heads"], 8
    pools = {n: [rng.standard_normal((NB, BS, kvh, D)).astype(np.float32)
                 for _ in range(2)] for n in ("k", "v")}
    # distinct blocks: no two live rows of a step share a cell
    tables = rng.permutation(NB)[:S * MB].reshape(S, MB).astype(np.int32)
    tables[rng.random((S, MB)) < 0.2] = -1
    pos = rng.integers(0, 40, S).astype(np.int32)
    act = np.array([True, False, True])
    last = rng.integers(0, CFG["vocab_size"], (S, 1)).astype(np.int32)
    return pools, tables, pos, act, last


def jax_kv(pools):
    return {n: [jnp.asarray(p) for p in ps] for n, ps in pools.items()}


def port_kv(pools):
    """Stores: the pools plus a zero sink block."""
    out = {}
    for n, ps in pools.items():
        out[n] = []
        for p in ps:
            st = torch.zeros((NB + 1,) + p.shape[1:])
            st[:NB] = torch.from_numpy(p)
            out[n].append(st)
    return out


def pools_close(got_stores, want_kv, what):
    for n in want_kv:
        for li, (g, w) in enumerate(zip(got_stores[n], want_kv[n])):
            close(g[:NB].numpy(), np.asarray(w), f"{what} {n}{li}")


def t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# the device write plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [None, "int8"])
def test_write_plan_matches_jax_write_kv(models, quant):
    """The cells of ``kv_write_rows`` + ``write_kv_rows`` equal JAX
    ``_write_kv``'s over random tables with unmapped entries, masked
    rows and positions at and past ``max_blocks * block_size`` (the
    clamped block); dropped rows land in the sink and nowhere else."""
    jm, tm = models
    geo = dict(GEO, num_blocks=NB)
    jeng = JaxPaged(jm, kv_quant=quant, **geo)
    peng = PagedLlamaDecodeEngine(tm, kv_quant=quant, device="cpu", **geo)
    rng = np.random.default_rng(11)
    kvh, D = 2, 8
    T = 5
    tables = rng.integers(0, NB, (S, MB)).astype(np.int32)
    tables[rng.random((S, MB)) < 0.3] = -1
    positions = rng.integers(0, MB * BS, (S, T)).astype(np.int32)
    positions[0, 0] = MB * BS          # past the table: the last block
    positions[1, 1] = MB * BS - 1
    wmask = rng.random((S, T)) < 0.7
    # one live cell per (block, offset): no two live rows collide
    flat = []
    for s in range(S):
        for i in range(T):
            b = tables[s, min(positions[s, i] // BS, MB - 1)]
            cell = (b, positions[s, i] % BS)
            if b >= 0 and wmask[s, i] and cell in flat:
                wmask[s, i] = False
            elif b >= 0 and wmask[s, i]:
                flat.append(cell)
    k = rng.standard_normal((S, T, kvh, D)).astype(np.float32)
    v = rng.standard_normal((S, T, kvh, D)).astype(np.float32)
    jkvl = {n: jeng.kvs[n][0] for n in jeng.kvs}
    want = jeng._write_kv(jkvl, jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(positions), jnp.asarray(tables),
                          jnp.asarray(wmask))
    stores = {n: peng._kv_store[n][0].clone() for n in peng._kv_store}
    rows = tsc.kv_write_rows(t(positions), t(tables), t(wmask), BS, NB)
    assert rows.shape == (S * T,) and rows.dtype == torch.int64
    peng._write_kv(stores, t(k), t(v), rows)
    for n in want:
        close(stores[n][:NB].numpy(), np.asarray(want[n]), n)
    dropped = (~torch.from_numpy(wmask).reshape(-1)) | (
        torch.from_numpy(np.take_along_axis(
            tables, np.minimum(positions // BS, MB - 1), 1)).reshape(-1) < 0)
    assert bool((rows[dropped] == NB * BS).all())
    assert bool((rows[~dropped] < NB * BS).all())
    sink = stores["k"][NB]
    assert (int(dropped.sum()) > 0) == bool(sink.abs().sum() > 0)


# ---------------------------------------------------------------------------
# the paged bodies
# ---------------------------------------------------------------------------

def test_decode_impl_matches_jax(engines):
    jeng, peng = engines
    pools, tables, pos, act, last = state(1)
    jnxt, jkv = jax.jit(jeng._decode_impl)(
        jeng.params, jax_kv(pools), jnp.asarray(last), jnp.asarray(pos),
        jnp.asarray(tables), jnp.asarray(act))
    n_tiles = int(pos.max()) // BS + 1
    jlogits, _ = jax.jit(jeng._forward_paged, static_argnums=5)(
        jeng.params, jax_kv(pools), jnp.asarray(last),
        jnp.asarray(pos)[:, None], jnp.asarray(tables), n_tiles,
        jnp.asarray(act)[:, None])
    stores = port_kv(pools)
    nxt, logits, kv = peng._decode_impl(peng.params, stores, t(last), t(pos),
                                        t(tables), t(act))
    assert kv is stores and nxt.dtype == torch.int32
    assert nxt.tolist() == np.asarray(jnxt).tolist()
    close(logits.numpy(), np.asarray(jlogits)[:, -1], "logits")
    pools_close(stores, jkv, "pools")
    # inactive slots wrote nothing but the sink
    assert float(stores["k"][0][NB].abs().sum()) > 0


@pytest.mark.parametrize("c", [1, 8, 9, 16], ids=lambda c: f"chunk{c}")
def test_prefill_impl_matches_jax_at_bucket_edges(engines, c):
    """One chunk of ``c`` tokens padded to its bucket (8, 8, 16, 16 at
    chunk 16) for slot 1 from position 6 of a 30-token prompt."""
    jeng, peng = engines
    pools, tables, _, _, _ = state(2)
    b = min(peng._bucket(c), peng.prefill_chunk_len)
    assert b == min(jeng._bucket(c), jeng.prefill_chunk_len)
    rng = np.random.default_rng(c)
    ids = np.zeros((1, b), np.int32)
    ids[0, :c] = rng.integers(0, CFG["vocab_size"], c)
    start, n = 6, 6 + c
    row = tables[1]
    jtok, jkv = jax.jit(jeng._prefill_impl)(
        jeng.params, jax_kv(pools), jnp.asarray(ids), jnp.asarray(row),
        jnp.int32(start), jnp.int32(c), jnp.int32(n))
    offs = np.arange(b)
    jlogits, _ = jax.jit(jeng._forward_paged, static_argnums=5)(
        jeng.params, jax_kv(pools), jnp.asarray(ids),
        jnp.asarray(start + offs)[None, :], jnp.asarray(row)[None, :],
        (start + c - 1) // BS + 1, jnp.asarray(offs < c)[None, :])
    stores = port_kv(pools)
    tok, logits, _ = peng._prefill_impl(
        peng.params, stores, t(ids), t(row), t(np.int32(start)),
        t(np.int32(c)), t(np.int32(n)))
    assert int(tok) == int(jtok)
    close(logits.numpy(), np.asarray(jlogits)[0, c - 1], "logits")
    pools_close(stores, jkv, "pools")


def test_propose_and_verify_match_jax(engines):
    """The draft's k chained steps in one body and the target's verify
    window, on the same pools: proposals, targets, accepted lengths,
    window logits and pools."""
    jeng, peng = engines
    k = 3
    pools, tables, pos, act, last = state(3)
    jeng._spec_propose_k = peng._spec_propose_k = k
    jtok, jkv = jax.jit(jeng._propose_impl)(
        jeng.params, jax_kv(pools), jnp.asarray(last), jnp.asarray(pos),
        jnp.asarray(tables), jnp.asarray(act))
    stores = port_kv(pools)
    tok, _ = peng._propose_impl(peng.params, stores, t(last), t(pos),
                                t(tables), t(act))
    assert tok.tolist() == np.asarray(jtok).tolist()
    pools_close(stores, jkv, "propose pools")
    # verify a window whose first proposals match the target's greedy
    # tokens in slot 0 (the accepted length is then > 0 there)
    draft = np.asarray(jtok).copy()
    draft[2, 1] = (draft[2, 1] + 1) % CFG["vocab_size"]
    jt, jn, jkv2 = jax.jit(jeng._spec_verify_impl)(
        jeng.params, jax_kv(pools), jnp.asarray(last), jnp.asarray(draft),
        jnp.asarray(pos), jnp.asarray(tables), jnp.asarray(act))
    ids = np.concatenate([last, draft], axis=1)
    positions = pos[:, None] + np.arange(k + 1)
    jlogits, _ = jax.jit(jeng._forward_paged, static_argnums=5)(
        jeng.params, jax_kv(pools), jnp.asarray(ids), jnp.asarray(positions),
        jnp.asarray(tables), (int(pos.max()) + k) // BS + 1,
        jnp.asarray(np.broadcast_to(act[:, None], positions.shape)))
    stores = port_kv(pools)
    tt, n_acc, logits, _ = peng._spec_verify_impl(
        peng.params, stores, t(last), t(draft), t(pos), t(tables), t(act))
    assert tt.tolist() == np.asarray(jt).tolist()
    assert n_acc.tolist() == np.asarray(jn).tolist()
    close(logits.numpy(), np.asarray(jlogits), "window logits")
    pools_close(stores, jkv2, "verify pools")


@pytest.mark.parametrize("quant", [None, "int8"])
def test_cow_impl_matches_jax(models, quant):
    jm, tm = models
    jeng = JaxPaged(jm, kv_quant=quant, **GEO)
    peng = PagedLlamaDecodeEngine(tm, kv_quant=quant, device="cpu", **GEO)
    rng = np.random.default_rng(5)
    pools = {n: [rng.standard_normal(np.asarray(p).shape).astype(
        np.asarray(p).dtype) if quant is None or n in ("ksc", "vsc")
        else rng.integers(-127, 128, np.asarray(p).shape).astype(np.int8)
        for p in ps] for n, ps in jeng.kvs.items()}
    want = jax.jit(jeng._cow_impl)(jeng.params, jax_kv(pools),
                                   jnp.int32(7), jnp.int32(2))
    stores = {n: [torch.cat([torch.from_numpy(p), torch.zeros(
        (1,) + p.shape[1:], dtype=torch.from_numpy(p).dtype)])
        for p in ps] for n, ps in pools.items()}
    peng._cow_impl(stores, t(np.int64(7)), t(np.int64(2)))
    for n in want:
        for g, w in zip(stores[n], want[n]):
            assert np.array_equal(g[:NB].numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the dense bodies
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense(models):
    jm, tm = models
    return (JaxDense(jm, max_slots=2, max_seq=32),
            LlamaDecodeEngine(tm, max_slots=2, max_seq=32, device="cpu"))


def dense_caches(seed):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
             for _ in range(2)] for _ in range(2)]


def test_dense_decode_impl_matches_jax(dense):
    jeng, peng = dense
    kc, vc = dense_caches(6)
    last = np.array([[5], [9]], np.int32)
    pos = np.array([17, 3], np.int32)
    jnxt, jk, jv = jax.jit(jeng._decode_impl)(
        jeng.params, [jnp.asarray(c) for c in kc],
        [jnp.asarray(c) for c in vc], jnp.asarray(last), jnp.asarray(pos))
    tk, tv = [t(c).clone() for c in kc], [t(c).clone() for c in vc]
    nxt, logits, _, _ = peng._decode_impl(peng.params, tk, tv, t(last),
                                          t(pos))
    assert nxt.tolist() == np.asarray(jnxt).tolist()
    assert logits.argmax(-1).tolist() == nxt.tolist()
    for g, w in zip(tk + tv, list(jk) + list(jv)):
        close(g.numpy(), np.asarray(w), "caches")


@pytest.mark.parametrize("n", [1, 8, 9, 20])
def test_dense_prefill_impl_matches_jax(dense, n):
    jeng, peng = dense
    kc, vc = dense_caches(7)
    b = peng._bucket(n)
    assert b == jeng._bucket(n)
    ids = np.zeros((1, b), np.int32)
    ids[0, :n] = np.arange(3, 3 + n) % CFG["vocab_size"]
    jtok, jk, jv = jax.jit(jeng._prefill_impl)(
        jeng.params, [jnp.asarray(c) for c in kc],
        [jnp.asarray(c) for c in vc], jnp.asarray(ids), jnp.int32(1),
        jnp.int32(n))
    tk, tv = [t(c).clone() for c in kc], [t(c).clone() for c in vc]
    tok, _, _, _ = peng._prefill_impl(peng.params, tk, tv, t(ids),
                                      t(np.int64(1)), t(np.int32(n)))
    assert int(tok) == int(jtok)
    for g, w in zip(tk + tv, list(jk) + list(jv)):
        close(g.numpy(), np.asarray(w), "caches")


# ---------------------------------------------------------------------------
# capture_jit on the CPU, the positional int8 argument
# ---------------------------------------------------------------------------

def _fallbacks(reason):
    c = om.default_registry().get("sot.fallbacks_total")
    return c.value(reason=reason) if c is not None else 0


def test_capture_jit_accounting_on_cpu(monkeypatch):
    """On the CPU a program runs op by op: the first call of a signature
    counts as eager, later ones as fallbacks of reason "device"; the
    warm-bundle note is made after each signature's first successful
    call (``warm`` may be a function of the arguments); no graph is
    captured and no compile event is journaled. The kill switch runs
    the body and counts nothing."""
    noted = []
    monkeypatch.setattr(twarmup, "note_program",
                        lambda kind, name, rec: noted.append(
                            (kind, name, rec)))
    calls = []

    def body(w, buf, x, i):
        calls.append(1)
        buf.index_copy_(0, i.reshape(1).long(), (w * x).sum().reshape(1))
        return (w * x).sum(), buf

    w, buf = torch.arange(4.0), torch.zeros(3)
    prog = tsot.capture_jit(body, donate_argnums=(0, 1), name="t.prog",
                            warm={"program": "p"})
    before = _fallbacks("device")
    n_events = len(flight.events(category="sot"))
    out, got = prog(w, buf, np.ones(4, np.float32), np.int32(1))
    assert float(out) == 6.0 and got is buf and float(buf[1]) == 6.0
    out, _ = prog(w, buf, np.full(4, 2, np.float32), np.int32(2))
    assert float(out) == 12.0 and buf.tolist() == [0.0, 6.0, 12.0]
    assert prog.stats["eager"] == 1 and prog.stats["fallbacks"] == 1
    assert prog.stats["captures"] == prog.stats["replays"] == 0
    assert _fallbacks("device") == before + 1
    assert noted == [("serving", "t.prog", {"meta": {"program": "p"}})]
    assert not [e for e in flight.events(category="sot")[n_events:]
                if e["name"] == "capture_compile"]
    # a new signature is a first sighting again
    prog(w, buf, np.ones(5, np.float32)[:4], np.int64(0))
    assert prog.stats["eager"] == 2 and len(noted) == 2
    set_flags({"FLAGS_sot_capture": False})
    try:
        stats = dict(prog.stats)
        out, _ = prog(w, buf, np.ones(4, np.float32), np.int32(0))
        assert float(out) == 6.0 and prog.stats == stats
    finally:
        set_flags({"FLAGS_sot_capture": True})
    assert len(calls) == 4 and len(noted) == 2
    assert prog._group.graphs() == 0 and prog._group.pool_bytes() == 0
    # a warm function: the meta of each signature from its arguments
    noted.clear()
    prog = tsot.capture_jit(body, donate_argnums=(0, 1), name="t.fn",
                            warm=lambda w, buf, x, i: {"n": x.shape[0]})
    for n in (4, 4, 2):
        prog(w[:n], buf, np.ones(n, np.float32), np.int32(0))
    assert [rec["meta"] for _, _, rec in noted] == [{"n": 4}, {"n": 2}]


def test_engine_programs_share_one_group(engines):
    _, peng = engines
    progs = {p.name for p in peng._graphs.programs}
    assert {"serving.paged_decode"} <= progs
    assert all(p._group is peng._graphs for p in peng._graphs.programs)


def test_positional_int8_is_the_jax_fourth_argument(models):
    """``Engine(model, slots, max_seq, True)`` means ``int8=True`` in both
    packages; ``eos_id`` is the fifth."""
    jm, tm = models
    for cls, jcls in ((LlamaDecodeEngine, JaxDense),
                      (PagedLlamaDecodeEngine, JaxPaged)):
        eng = cls(tm, 2, 32, True, 7, device="cpu")
        jeng = jcls(jm, 2, 32, True, 7)
        assert eng.int8 is jeng.int8 is True
        assert eng.eos_id == jeng.eos_id == 7
        assert isinstance(eng.params["layers"][0]["q_proj"], tuple)
        assert eng.params["layers"][0]["q_proj"][0].dtype == torch.int8
