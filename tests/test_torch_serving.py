"""Serving parity: the port's engines and GenerationServer against the
JAX package's, on a tiny f32 Llama with the same weights carried
across. Greedy token streams must be exactly equal; first-step logits
within f32 atol 1e-4 (same math, other summation orders)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import GenerationServer as JaxServer
from paddle_tpu.serving import PagedLlamaDecodeEngine as JaxPaged
from paddle_tpu_torch.convert import load_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import flight
from paddle_tpu_torch.ops.kernels import paged_attention as tpk
from paddle_tpu_torch.serving import (GenerationServer, LlamaDecodeEngine,
                                      PagedLlamaDecodeEngine)

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, use_flash_attention=False)
GEO = dict(max_slots=4, max_seq=64, block_size=4, prefill_chunk=8,
           num_blocks=12)
PROMPTS = [[5, 9, 11, 3], list(range(1, 14)), list(range(3, 33))]


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JaxLlama(JaxConfig.tiny(**CFG))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_from_jax(tm, {k: np.asarray(v._data)
                       for k, v in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def jax_engine(models):
    return JaxPaged(models[0], **GEO)


def _port(tm, **kw):
    return PagedLlamaDecodeEngine(tm, device="cpu", **{**GEO, **kw})


def test_paged_generate_matches_jax(models, jax_engine):
    _, tm = models
    eng = _port(tm)
    for prompt in PROMPTS:
        want = jax_engine.generate(prompt, max_new_tokens=10)
        assert eng.generate(prompt, max_new_tokens=10) == want, prompt
    assert eng._kv.stats()["blocks_used"] == 0
    eng._kv.check_invariants()


def test_first_step_logits_match_jax(models, jax_engine):
    """Prefill a prompt longer than one chunk into both engines, then
    hold the next decode step's logits side by side."""
    _, tm = models
    prompt = PROMPTS[2]
    jax_engine.prefill(1, prompt, budget=4)
    eng = _port(tm)
    first = eng.prefill(1, prompt, budget=4)
    assert int(np.argmax(eng.last_logits.numpy())) == first
    try:
        jax_engine._extend_tables()
        bs = jax_engine.block_size
        fwd = jax.jit(functools.partial(
            jax_engine._forward_paged,
            n_tiles=int(jax_engine.pos.max()) // bs + 1))
        want, _ = fwd(jax_engine.params, jax_engine.kvs,
                      jnp.asarray(jax_engine.last_ids),
                      jnp.asarray(jax_engine.pos)[:, None],
                      jnp.asarray(jax_engine._kv.block_tables),
                      wmask=jnp.asarray(jax_engine.active)[:, None])
        eng.step()
        got = eng.last_logits.numpy()
        np.testing.assert_allclose(got[1], np.asarray(want)[1, -1],
                                   atol=1e-4, rtol=0)
    finally:
        jax_engine.release(1)
        eng.release(1)


@pytest.mark.parametrize("kv_quant", ["bfloat16", "int8"])
def test_quantized_kv_streams_match_jax(models, kv_quant):
    jm, tm = models
    jeng = JaxPaged(jm, kv_quant=kv_quant, **GEO)
    eng = _port(tm, kv_quant=kv_quant)
    pools = eng.kvs
    assert pools["k"][0].dtype == {"bfloat16": torch.bfloat16,
                                   "int8": torch.int8}[kv_quant]
    assert ("ksc" in pools) == (kv_quant == "int8")
    for prompt in PROMPTS[1:]:
        want = jeng.generate(prompt, max_new_tokens=12)
        assert eng.generate(prompt, max_new_tokens=12) == want, prompt


def test_paged_and_dense_streams_are_equal(models):
    _, tm = models
    paged = _port(tm)
    dense = LlamaDecodeEngine(tm, max_slots=4, max_seq=64, device="cpu")
    for prompt in PROMPTS:
        assert paged.generate(prompt, 14) == dense.generate(prompt, 14)


@pytest.mark.parametrize("cls", ["paged", "dense"])
def test_decode_steps_equal_single_steps(models, cls):
    _, tm = models

    def make():
        if cls == "paged":
            return _port(tm, num_blocks=64)
        return LlamaDecodeEngine(tm, max_slots=4, max_seq=64, device="cpu")

    a, b = make(), make()
    for eng in (a, b):
        for s, prompt in enumerate(PROMPTS + [[7, 7]]):
            if cls == "paged":
                eng.prefill(s, prompt, budget=8)
            else:
                eng.prefill(s, prompt)
    window = a.decode_steps(5)
    singles = np.stack([b.step() for _ in range(5)], axis=1)
    np.testing.assert_array_equal(window, singles)
    np.testing.assert_array_equal(a.pos, b.pos)
    with pytest.raises(ValueError, match="write past"):
        a.decode_steps(64)


def test_block_aligned_prefix_hit_copies_on_write(models):
    """A prompt fully covered by cached blocks re-prefills only its last
    token into a copy-on-write clone; the stream equals a cold one."""
    _, tm = models
    prompt = list(range(10, 18))                 # two full blocks
    cold = _port(tm).generate(prompt, 8)
    eng = _port(tm)
    assert eng.generate(prompt, 8) == cold
    assert eng.begin_request(0, prompt, 8)
    assert eng.prefix_hit_tokens[0] == len(prompt) - 1
    first = None
    while first is None:
        first = eng.prefill_chunk(0)
    out = [first] + [int(eng.step()[0]) for _ in range(7)]
    assert out == cold
    eng.release(0)
    eng._kv.check_invariants()


def test_reset_state_rebuilds_zero_pools(models):
    _, tm = models
    eng = _port(tm, kv_quant="int8")
    eng.prefill(0, PROMPTS[1], budget=4)
    assert any(p.abs().sum() > 0 for p in eng.kvs["k"])
    eng.reset_state()
    assert all(p.abs().sum() == 0 for ps in eng.kvs.values() for p in ps)
    assert eng._kv.stats()["blocks_used"] == 0
    assert not eng.active.any() and eng._kv.cached_blocks() == 0
    assert eng.generate(PROMPTS[1], 6) == _port(tm, kv_quant="int8") \
        .generate(PROMPTS[1], 6)


def test_engine_shares_the_model_weights(models):
    _, tm = models
    eng = _port(tm, num_layers=1)
    assert eng.params["emb"].data_ptr() == \
        tm.llama.embed_tokens.weight.data_ptr()
    assert eng.params["layers"][0]["q_proj"].data_ptr() == \
        tm.llama.layers[0].self_attn.q_proj.weight.data_ptr()
    assert len(eng.params["layers"]) == 1 and eng.n_layers == 1
    assert len(eng.kvs["k"]) == 1
    with pytest.raises(ValueError, match="num_layers"):
        _port(tm, num_layers=3)


def _server_requests():
    """Six requests over 4 slots and a 12-block pool: two prompts longer
    than one 8-token chunk, two sharing a block-aligned 8-token prefix
    (the second submitted once the first has prefilled, so it finds the
    first's blocks in the radix tree), and enough total demand that
    admission must defer."""
    shared = [21, 22, 23, 24, 25, 26, 27, 28]
    return [(shared + [1, 2, 3], 8), (shared + [4, 4, 4, 4], 8),
            (list(range(30, 47)), 6), (list(range(2, 14)), 8),
            (list(range(40, 60)), 8), ([9, 8, 7, 6, 5], 6)]


def _serve(engine, server_cls):
    srv = server_cls(engine)
    try:
        todo = _server_requests()
        reqs = [srv.submit(*todo[0])]
        for _ in range(6000):                   # first token: prefilled
            if reqs[0]["out"] or reqs[0]["done"].is_set():
                break
            reqs[0]["done"].wait(0.01)
        reqs += [srv.submit(p, m) for p, m in todo[1:]]
        for r in reqs:
            assert r["done"].wait(180), "request did not finish"
            assert r["error"] is None, r["error"]
        return [list(r["out"]) for r in reqs], reqs
    finally:
        assert srv.shutdown(drain=True, timeout=120)


def test_generation_server_matches_jax(models, jax_engine):
    _, tm = models
    want, _ = _serve(jax_engine, JaxServer)
    flight.clear()
    eng = _port(tm)
    launches = tpk.paged_attention_kernel.launches
    got, reqs = _serve(eng, GenerationServer)
    assert got == want
    for (prompt, budget), out in zip(_server_requests(), got):
        assert len(out) == budget
    names = [e["name"] for e in flight.events(category="serving")]
    assert "block_exhausted" in names            # one request deferred
    assert reqs[1]["prefix_hit_tokens"] == 8     # the shared prefix hit
    assert all(r["t0"] <= r["t_admit"] <= r["t_first"] for r in reqs)
    assert tpk.paged_attention_kernel.launches == launches  # CPU: walk
    assert eng._kv.stats()["blocks_used"] == 0
    eng._kv.check_invariants()


def test_dense_server_matches_paged_server(models):
    _, tm = models
    paged, _ = _serve(_port(tm), GenerationServer)
    dense, _ = _serve(LlamaDecodeEngine(tm, max_slots=4, max_seq=64,
                                        device="cpu"), GenerationServer)
    assert dense == paged


def test_server_deadlines_shutdown_and_stats(models):
    _, tm = models
    eng = _port(tm)
    srv = GenerationServer(eng)
    try:
        ok = srv.submit(PROMPTS[0], 4)
        # fits the pool, so only its deadline can fail it: expired while
        # queued, or at a step boundary of its multi-chunk prefill
        late = srv.submit(PROMPTS[2], 10, deadline=1e-4)
        assert ok["done"].wait(60) and ok["error"] is None
        assert late["done"].wait(60)
        assert isinstance(late["error"], TimeoutError)
        with pytest.raises(ValueError, match="max_new_tokens"):
            srv.submit([1], 0)
        with pytest.raises(ValueError, match="deadline"):
            srv.submit([1], 2, deadline=0)
        st = srv.stats()
        assert st["deadline_expired"] == 1 and st["admitted"] >= 1
        assert st["kv_pool"]["blocks_used"] == 0
        assert GenerationServer.trace(ok)[0]["name"] == "submit"
    finally:
        assert srv.shutdown(drain=True, timeout=60)
    with pytest.raises(RuntimeError, match="shutting down"):
        srv.submit([1, 2], 2)
    assert srv.stats()["drained"] == 1
    assert not srv._thread.is_alive()


def test_static_shed_policy_rejects_under_block_starvation(models):
    from paddle_tpu_torch.core.flags import set_flags
    _, tm = models
    eng = _port(tm, num_blocks=4, max_slots=2)
    srv = GenerationServer(eng)
    set_flags({"serving_shed_queue": 1})
    try:
        srv._waiting += [{"done": None}] * 2     # two requests deferred
        eng._kv.admit(0, 15, 16)                 # the pool is all taken
        assert srv._shed()
        with pytest.raises(RuntimeError, match="reason=shed"):
            srv.submit([1, 2, 3], 2)
        assert srv.stats()["shed"] == 1
    finally:
        set_flags({"serving_shed_queue": 0})
        srv._waiting.clear()
        eng._kv.release(0)
        assert srv.shutdown(drain=True, timeout=60)
