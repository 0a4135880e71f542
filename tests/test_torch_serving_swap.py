"""Weight hot-swap: the port's ``swap_weights`` (engine and server)
against the JAX package's, on the tiny f32 Llama of
test_torch_serving.py. Two weight sets are drawn on the JAX side and
carried across with ``convert.load_from_jax``; an engine swapped from
the first to the second mid-stream must give the JAX engine's tokens
after the same swap, a rejected swap leaves the old weights installed,
and the server applies a swap only at a step boundary."""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import PagedLlamaDecodeEngine as JaxPaged
from paddle_tpu_torch.convert import load_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.serving import GenerationServer, PagedLlamaDecodeEngine

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, use_flash_attention=False)
GEO = dict(max_slots=2, max_seq=64, block_size=8, prefill_chunk=8)


def _pair(seed):
    paddle.seed(seed)
    jm = JaxLlama(JaxConfig.tiny(**CFG))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_from_jax(tm, {k: np.asarray(v._data)
                       for k, v in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    """Weight sets A and B: (jax model, port model) each."""
    return _pair(7), _pair(11)


def _port(tm, draft=True, **kw):
    eng = PagedLlamaDecodeEngine(tm, device="cpu", **{**GEO, **kw})
    if draft:
        eng.attach_draft(eng.make_draft(num_layers=1), spec_tokens=3)
    return eng


def _counter(name):
    return om.default_registry().get("serving." + name)


def test_engine_swap_mid_stream_matches_jax(models):
    """Both packages decode (spec steps and plain steps) on A, swap to B
    between steps, and go on: every step's tokens, counts and positions
    agree across the packages before and after the swap, the sharing
    draft follows the target, and an unswapped engine parts from the
    swapped one (the swap took effect)."""
    (jma, tma), (jmb, tmb) = models
    je = JaxPaged(jma, **GEO)
    je.attach_draft(je.make_draft(jma, num_layers=1), spec_tokens=3)
    pe, still = _port(tma), _port(tma)
    for eng in (je, pe, still):
        eng.prefill(0, [5, 9, 11, 3], budget=30)
        eng.prefill(1, list(range(1, 14)), budget=30)

    def compare(steps, spec):
        outs = []
        for _ in range(steps):
            got = []
            for eng in (je, pe, still):
                if spec:
                    toks, counts = eng.spec_step()
                else:
                    toks, counts = eng.step()[:, None], np.ones(2, int)
                got.append((np.asarray(toks), np.asarray(counts)))
            (jt, jc), (pt, pc) = got[0], got[1]
            np.testing.assert_array_equal(jc, pc)
            np.testing.assert_array_equal(jt, pt)
            np.testing.assert_array_equal(je.pos, pe.pos)
            outs.append((pt, got[2][0]))
        return outs

    compare(3, spec=True)
    je.swap_weights(jmb.state_dict())
    pe.swap_weights(tmb.state_dict())
    draft = pe._draft
    assert draft.params["emb"] is pe.params["emb"]
    assert draft.params["emb"].data_ptr() == \
        tmb.llama.embed_tokens.weight.data_ptr()
    for nm, w in pe.params["layers"][0].items():
        assert draft.params["layers"][0][nm] is w
    after = compare(3, spec=True) + compare(2, spec=False)
    assert any(not np.array_equal(a, b) for a, b in after)
    for eng in (pe, still):
        eng._kv.check_invariants()
        eng._draft._kv.check_invariants()


def test_rejected_swap_keeps_the_old_weights(models):
    """Another shape, a missing leaf, another dtype, another device:
    each raises with the old weight tree installed, and the engine's
    stream goes on as if nothing was tried."""
    (_, tma), _ = models
    eng = _port(tma, draft=False)
    ref = eng.generate([3, 2, 1], max_new_tokens=6)
    old = eng.params
    wrong = LlamaForCausalLM(LlamaConfig.tiny(
        **dict(CFG, hidden_size=16, intermediate_size=32)), device="cpu")
    with pytest.raises(ValueError, match="weight swap rejected"):
        eng.swap_weights(wrong.state_dict())
    missing = dict(tma.state_dict())
    missing.pop("llama.norm.weight")
    with pytest.raises(ValueError, match="llama.norm.weight"):
        eng.swap_weights(missing)
    for leaf in (lambda w: w.double(),
                 lambda w: torch.empty(w.shape, device="meta")):
        tree = eng.prepare_swap(tma.state_dict())
        tree["layers"][1]["up_proj"] = leaf(tree["layers"][1]["up_proj"])
        with pytest.raises(ValueError, match="layers.1.up_proj"):
            eng.swap_weights(prepared=tree)
    assert eng.params is old
    assert eng.generate([3, 2, 1], max_new_tokens=6) == ref


def test_independent_draft_keeps_its_weights(models):
    (_, tma), (_, tmb) = models
    eng = _port(tma, draft=False)
    draft = PagedLlamaDecodeEngine(tma, device="cpu", num_layers=1, **GEO)
    eng.attach_draft(draft, spec_tokens=2)
    kept = draft.params
    eng.swap_weights(tmb.state_dict())
    assert draft.params is kept
    assert eng.params["emb"].data_ptr() == \
        tmb.llama.embed_tokens.weight.data_ptr()


def _wait_tokens(req, n, timeout=30.0):
    t_end = time.monotonic() + timeout
    while len(req["out"]) < n and not req["done"].is_set():
        assert time.monotonic() < t_end, "request made no progress"
        time.sleep(0.001)


def test_same_weights_swap_at_the_step_boundary_is_transparent(models):
    """A swap to a COPY of the same weights while a request streams: it
    lands at a step boundary with the request in flight, the engine now
    holds the copies, and the stream equals a never-swapped run."""
    (_, tma), _ = models
    prompt = list(range(1, 9))
    srv = GenerationServer(_port(tma, draft=False))
    try:
        ref = srv.generate(prompt, max_new_tokens=40, timeout=120)
    finally:
        assert srv.shutdown(timeout=60)
    eng = _port(tma, draft=False)
    srv = GenerationServer(eng)
    swaps = _counter("weight_swaps_total").value()
    try:
        req = srv.submit(prompt, max_new_tokens=40)
        _wait_tokens(req, 4)
        copy = {k: v.clone() for k, v in tma.state_dict().items()}
        res = srv.swap_weights(copy, timeout=60)
        assert req["done"].wait(60) and req["error"] is None
        assert list(req["out"]) == ref
        assert res["in_flight"] == 1 and res["seconds"] >= 0
        assert eng.params["emb"].data_ptr() == \
            copy["llama.embed_tokens.weight"].data_ptr()
        assert srv.stats()["weight_swaps"] == 1
        assert _counter("weight_swaps_total").value() == swaps + 1
        eng._kv.check_invariants()
    finally:
        assert srv.shutdown(timeout=60)


def test_server_swap_switches_weights_and_the_draft(models):
    """A mid-stream swap to B on a speculative server: the request
    streams to its full budget, the sharing draft is re-pointed, and a
    request after the swap equals a plain engine booted on B."""
    (_, tma), (_, tmb) = models
    eng = _port(tma)
    srv = GenerationServer(eng)
    try:
        req = srv.submit([2, 4, 6, 8], max_new_tokens=50)
        _wait_tokens(req, 4)
        srv.swap_weights(tmb.state_dict(), timeout=60)
        assert req["done"].wait(60) and len(req["out"]) == 50
        assert eng._draft.params["emb"] is eng.params["emb"]
        out = srv.generate([9, 8, 7], max_new_tokens=8, timeout=60)
    finally:
        assert srv.shutdown(timeout=60)
    plain = _port(tmb, draft=False)
    assert out == plain.generate([9, 8, 7], max_new_tokens=8)
    eng._kv.check_invariants()
    eng._draft._kv.check_invariants()


def test_server_swap_rejections_keep_serving(models):
    """A leaf missing (refused while preparing, on the caller's thread)
    and a shape mismatch (refused at the step boundary): each raises to
    the caller, counts in weight_swaps_rejected_total, and the server
    serves on with the old weights."""
    (_, tma), _ = models
    srv = GenerationServer(_port(tma, draft=False))
    rejected = _counter("weight_swaps_rejected_total").value()
    try:
        ref = srv.generate([1, 2, 3], max_new_tokens=6, timeout=60)
        bad = dict(tma.state_dict())
        bad.pop("llama.norm.weight")
        with pytest.raises(ValueError):
            srv.swap_weights(bad, timeout=60)
        tree = srv.engine.prepare_swap(tma.state_dict())
        tree["norm"] = tree["norm"][:-1]
        with pytest.raises(ValueError, match="norm"):
            srv.swap_weights(prepared=tree, timeout=60)
        assert _counter("weight_swaps_rejected_total").value() == \
            rejected + 2
        assert srv.stats()["weight_swaps"] == 0
        assert srv.generate([1, 2, 3], max_new_tokens=6, timeout=60) == ref
    finally:
        assert srv.shutdown(timeout=60)


def test_swap_the_loop_never_reached_fails_at_shutdown(models):
    """A swap still pending when the loop drains cannot apply: its
    caller gets the reason at once, not a timeout. (The loop is kept
    from reaching its boundary by stubbing the boundary's apply.)"""
    (_, tma), _ = models
    srv = GenerationServer(_port(tma, draft=False))
    srv._apply_pending_swap = lambda: None
    got = []

    def swap():
        try:
            srv.swap_weights(tma.state_dict(), timeout=60)
        except Exception as e:  # noqa: BLE001 — the test reads it
            got.append(e)

    t = threading.Thread(target=swap, daemon=True)
    try:
        t.start()
        t_end = time.monotonic() + 30
        while srv._swap_req is None:
            assert time.monotonic() < t_end and t.is_alive()
            time.sleep(0.001)
    finally:
        assert srv.shutdown(timeout=60)
        t.join(timeout=30)
    assert not t.is_alive()
    assert len(got) == 1 and isinstance(got[0], RuntimeError)
    assert "shut down before the weight swap applied" in str(got[0])
    with pytest.raises(RuntimeError, match="shutting down"):
        srv.swap_weights(tma.state_dict())


def test_swap_sources(models, tmp_path):
    """A state dict nested under 'model' is taken; a checkpoint path and
    a checkpoint manager raise NotImplementedError naming the module
    they need, before anything is read."""
    (_, tma), _ = models
    srv = GenerationServer(_port(tma, draft=False))

    class Manager:
        def restore(self):
            raise AssertionError("must not be read")

    try:
        for source in (str(tmp_path / "ckpt"), tmp_path, Manager()):
            with pytest.raises(NotImplementedError,
                               match="framework/checkpoint.py"):
                srv.swap_weights(source, timeout=60)
        with pytest.raises(ValueError, match="state dict"):
            srv.swap_weights({"step": 3}, timeout=60)
        srv.swap_weights({"model": tma.state_dict(), "step": 3},
                         timeout=60)
        assert srv.stats()["weight_swaps"] == 1
    finally:
        assert srv.shutdown(timeout=60)
