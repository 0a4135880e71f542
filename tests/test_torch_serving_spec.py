"""Speculative decoding: the port's PagedLlamaDecodeEngine with a draft
attached against the JAX package's, on the tiny f32 Llama of
test_torch_serving.py with the same weights carried across.

The JAX contract holds in both packages: the greedy speculative stream
is bit-equal to plain stepping, because every committed token
conditions on a committed prefix. A 1-of-2-layer random draft disagrees
with its target constantly, so these streams reject mid-window and roll
back on nearly every step. Across the packages every ``spec_step`` must
give equal tokens, counts, positions and pool stats (same math in f32,
other summation orders: the greedy choices agree)."""
import time

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
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.serving import GenerationServer, PagedLlamaDecodeEngine

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, use_flash_attention=False)
GEO = dict(max_slots=2, max_seq=64, block_size=8, prefill_chunk=8)
PROMPTS = [[5, 9, 11, 3], [2], [1, 2, 3, 4, 5, 6, 7, 8],
           list(range(1, 14)), list(range(3, 33))]


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JaxLlama(JaxConfig.tiny(**CFG))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_from_jax(tm, {k: np.asarray(v._data)
                       for k, v in jm.named_parameters()})
    return jm, tm


def _port(tm, k=3, draft_layers=1, **kw):
    eng = PagedLlamaDecodeEngine(tm, device="cpu", **{**GEO, **kw})
    return eng.attach_draft(eng.make_draft(num_layers=draft_layers),
                            spec_tokens=k)


def _jax(jm, k=3, **kw):
    eng = JaxPaged(jm, **{**GEO, **kw})
    return eng.attach_draft(eng.make_draft(jm, num_layers=1),
                            spec_tokens=k)


@pytest.fixture(scope="module")
def plain(models):
    """Memoized non-speculative streams of each package (max_seq 256 so
    no reference stream truncates early)."""
    jm, tm = models
    engines = {"jax": JaxPaged(jm, max_slots=1, max_seq=256, block_size=8,
                               prefill_chunk=8),
               "port": PagedLlamaDecodeEngine(tm, max_slots=1, max_seq=256,
                                              block_size=8, prefill_chunk=8,
                                              device="cpu")}
    cache = {}

    def ref(pkg, prompt, n_new):
        key = (pkg, tuple(int(t) for t in prompt), int(n_new))
        if key not in cache:
            cache[key] = engines[pkg].generate(list(key[1]),
                                               max_new_tokens=n_new)
        return cache[key]

    return ref


def _check_pools(eng):
    eng._kv.check_invariants()
    eng._draft._kv.check_invariants()


def test_spec_steps_match_jax(models):
    """The same admissions into both packages — two slots, then a third
    request whose prompt shares a block-aligned prefix with the second
    (a radix-tree hit in both pools) admitted into the slot the first
    frees — and every spec_step compared: tokens of the active rows,
    counts, positions, both pools' stats."""
    jm, tm = models
    je, pe = _jax(jm), _port(tm)
    shared = list(range(1, 17))
    steps = 0

    def both(fn):
        return fn(je), fn(pe)

    for eng in (je, pe):
        eng.prefill(0, [5, 9, 11, 3], budget=12)
        eng.prefill(1, shared + [40, 41], budget=24)
    for i in range(9):
        if i == 4:
            for eng in (je, pe):
                eng.release(0)
                eng.prefill(0, shared + [7], budget=12)
            assert je.prefix_hit_tokens[0] == pe.prefix_hit_tokens[0] == 16
        assert je.spec_ready() and pe.spec_ready()
        (jt, jc), (pt, pc) = both(lambda e: e.spec_step())
        steps += 1
        np.testing.assert_array_equal(jc, pc)
        for s in np.nonzero(pe.active)[0]:
            np.testing.assert_array_equal(np.asarray(jt)[s], pt[s])
        np.testing.assert_array_equal(je.pos, pe.pos)
        np.testing.assert_array_equal(je.last_ids, pe.last_ids)
        assert je._kv.stats() == pe._kv.stats()
        assert je._draft._kv.stats() == pe._draft._kv.stats()
        np.testing.assert_array_equal(pe._draft.pos, pe.pos)
        _check_pools(pe)
    assert steps == 9


def _wait_all(reqs, timeout=180):
    """Every request done within ONE deadline, without an error."""
    t_end = time.monotonic() + timeout
    for r in reqs:
        assert r["done"].wait(max(0.0, t_end - time.monotonic())), \
            "request did not finish"
        assert r["error"] is None, r["error"]


def _serve(engine, server_cls, todo):
    srv = server_cls(engine)
    try:
        reqs = [srv.submit(p, m) for p, m in todo]
        _wait_all(reqs)
        return [list(r["out"]) for r in reqs], srv.stats()
    finally:
        assert srv.shutdown(drain=True, timeout=120)


def test_server_streams_match_jax_and_plain_stepping(models, plain):
    """Greedy speculative streams through each package's server equal
    each other and plain stepping in each package, for prompts across
    the prefill chunking; concurrently over 4 slots, with admission
    deferring on the pool, too. Both pools drain clean."""
    jm, tm = models
    todo = [(p, 12) for p in PROMPTS]
    want = [plain("port", p, m) for p, m in todo]
    assert want == [plain("jax", p, m) for p, m in todo]
    geo = dict(max_slots=4, num_blocks=16)
    got_jax, _ = _serve(_jax(jm, **geo), JaxServer, todo)
    pe = _port(tm, **geo)
    before = om.default_registry().get("serving.spec_steps_total").value()
    got, stats = _serve(pe, GenerationServer, todo)
    assert got == got_jax == want
    assert om.default_registry().get(
        "serving.spec_steps_total").value() > before
    assert stats["kv_pool"]["blocks_used"] == 0
    assert pe._draft._kv.stats()["blocks_used"] == 0
    _check_pools(pe)


def test_rejection_rolls_back_with_invariants(models, plain):
    """spec_step driven directly: the committed stream continues plain
    stepping's exactly, the allocator invariants hold after EVERY
    window on both pools, the counters move (proposed = k x steps) and
    rejected windows roll blocks back."""
    _, tm = models
    eng = _port(tm)
    reg = om.default_registry()
    names = ("spec_steps_total", "spec_proposed_total",
             "spec_accepted_total", "spec_rolled_back_total")
    before = {n: reg.get("serving." + n).value() for n in names}
    prompt = [5, 9, 11, 3]
    want = plain("port", prompt, 30)
    out = [eng.prefill(0, prompt, budget=30)]
    rejected = accepted = 0
    while len(out) < 30:
        toks, counts = eng.spec_step()
        m = int(counts[0])
        rejected += m < eng._spec_k
        out.extend(int(t) for t in toks[0, :m])
        _check_pools(eng)
        assert eng._kv.block_tables[0, int(eng.pos[0]) // 8 + 1:].max() < 0
    eng.release(0)
    assert out[:30] == want
    delta = {n: reg.get("serving." + n).value() - before[n] for n in names}
    assert delta["spec_proposed_total"] == \
        eng._spec_k * delta["spec_steps_total"]
    accepted = delta["spec_accepted_total"]
    assert 0 <= accepted < delta["spec_proposed_total"]
    assert rejected and delta["spec_rolled_back_total"] > 0
    assert eng._kv.stats()["blocks_used"] == 0
    _check_pools(eng)


def test_capacity_fallback_mixes_plain_and_spec_steps(models, plain):
    """A slot within spec_k of capacity (max_seq 32: a window from pos 27
    on would not fit) drops the batch to plain steps (the draft still
    mirrors them), then the stream ends at capacity: every delivered
    token continues plain stepping's stream."""
    _, tm = models
    eng = _port(tm, k=4, max_seq=32)
    reg = om.default_registry().get("serving.spec_steps_total")
    before = reg.value()
    srv = GenerationServer(eng)
    try:
        got = srv.generate([5, 9, 11, 3], 30, timeout=180)
        spec_steps = reg.value() - before
        plain_steps = srv.stats()["steps_run"] - spec_steps
    finally:
        assert srv.shutdown(drain=True, timeout=120)
    want = plain("port", [5, 9, 11, 3], 30)
    assert len(got) >= 25
    assert got == want[:len(got)]
    assert spec_steps >= 1 and plain_steps >= 1
    assert eng._kv.stats()["blocks_used"] == 0
    assert eng._draft._kv.stats()["blocks_used"] == 0


def test_draft_shares_the_target_tensors(models):
    """make_draft is a truncated-layer VIEW: every retained weight is
    the target's own tensor (same storage), and the draft owns only its
    KV pool."""
    _, tm = models
    eng = _port(tm)
    draft = eng._draft
    assert draft.n_layers == 1 and len(draft.kvs["k"]) == 1
    for name in ("emb", "head", "norm"):
        assert draft.params[name].data_ptr() == eng.params[name].data_ptr()
    for nm, w in eng.params["layers"][0].items():
        assert draft.params["layers"][0][nm].data_ptr() == w.data_ptr()
    assert draft.kvs["k"][0].data_ptr() != eng.kvs["k"][0].data_ptr()
    assert not draft._prefix_metrics and eng._prefix_metrics
    with pytest.raises(ValueError, match="TARGET"):
        eng.make_draft(num_layers=3)


def test_attach_draft_requires_an_idle_engine(models):
    _, tm = models
    eng = PagedLlamaDecodeEngine(tm, device="cpu", **GEO)
    eng.prefill(0, [1, 2, 3], budget=8)
    with pytest.raises(ValueError, match="IDLE"):
        eng.attach_draft(eng.make_draft(num_layers=1), spec_tokens=2)
    eng.release(0)
    other = PagedLlamaDecodeEngine(tm, device="cpu",
                                   **{**GEO, "max_seq": 32})
    with pytest.raises(ValueError, match="geometry"):
        eng.attach_draft(other, spec_tokens=2)
    eng.attach_draft(eng.make_draft(num_layers=1), spec_tokens=2)
    assert eng.generate([1, 2, 3], max_new_tokens=4)


def test_admission_reserves_the_spec_margin(models):
    """3 prompt tokens map 1 block of 8. A budget of 4 plus spec_k 3
    makes 10 tokens, so each pool reserves 1 more block; the bare
    engine's 7 tokens reserve none."""
    _, tm = models
    eng = _port(tm, num_blocks=8)
    assert eng.begin_request(0, [1, 2, 3], 4)
    assert eng._kv.stats()["blocks_reserved"] == 1
    assert eng._draft._kv.stats()["blocks_reserved"] == 1
    eng.release(0)
    bare = PagedLlamaDecodeEngine(tm, device="cpu", **GEO, num_blocks=8)
    assert bare.begin_request(0, [1, 2, 3], 4)
    assert bare._kv.stats()["blocks_reserved"] == 0


def test_brownout_drops_to_plain_steps_and_caps_chunks(models):
    """The adaptive policy's knobs as the server installs them:
    spec_off makes spec_ready() False, chunk_cap bounds a prefill chunk
    (floor 8)."""
    _, tm = models
    eng = _port(tm, prefill_chunk=16)
    srv = GenerationServer(eng)
    try:
        srv._apply_brownout(spec_off=True, chunk_cap=4)
        assert eng.begin_request(0, list(range(1, 21)), 4)
        assert eng.prefill_chunk(0) is None
        assert eng._prefill_state[0]["next"] == 8       # capped, floor 8
        while eng.prefill_chunk(0) is None:
            pass
        assert eng.active[0] and not eng.spec_ready()
        srv._apply_brownout(spec_off=False, chunk_cap=None)
        assert eng.spec_ready() and eng._chunk_cap is None
        eng.release(0)
    finally:
        assert srv.shutdown(drain=True, timeout=60)


def test_spec_step_reads_the_host_once(models, monkeypatch):
    """A spec step brings back ONE host value: the (t, n_acc) fetch.
    Every way a tensor's values reach the host is counted while
    spec_step runs (propose and verify included), except inside the
    attention seam: on the CPU it runs the plain walk, which reads its
    tile count on the host, where the card's kernel takes it as a device
    tensor (chip_smoke.py counts that path's device-to-host copies)."""
    from paddle_tpu_torch import serving_cache as sc
    _, tm = models
    eng = _port(tm)
    eng.prefill(0, [5, 9, 11, 3], budget=20)
    eng.prefill(1, list(range(1, 14)), budget=20)
    reads, seam = [], []
    for name in ("item", "tolist", "numpy", "__int__", "__float__",
                 "__bool__", "__index__", "__array__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            if not seam:
                reads.append(_name)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    attend = sc.paged_attention

    def uncounted(*a, **kw):
        seam.append(1)
        try:
            return attend(*a, **kw)
        finally:
            seam.pop()

    monkeypatch.setattr(sc, "paged_attention", uncounted)
    for _ in range(3):
        reads.clear()
        eng.spec_step()
        assert reads == ["numpy"]


def test_adaptive_brownout_keeps_the_streams(models, plain):
    """The adaptive policy on a starved pool (10 blocks, requests of up
    to 7 blocks each, so admission defers): the journal engages the
    speculative brownout first, the server runs plain steps under it,
    and every stream still equals plain stepping's."""
    from paddle_tpu_torch.serving_supervisor import AdaptiveAdmissionPolicy
    _, tm = models
    eng = _port(tm, num_blocks=10)
    pol = AdaptiveAdmissionPolicy(alpha=0.9, starve_frac=0.8,
                                  queue_bound=100)
    brownouts = om.default_registry().get(
        "serving.admission_brownouts_total")
    before = brownouts.value(knob="spec")
    srv = GenerationServer(eng, policy=pol)
    todo = [(p, 20) for p in PROMPTS]
    try:
        reqs = [srv.submit(p, m) for p, m in todo]
        _wait_all(reqs)
    finally:
        assert srv.shutdown(drain=True, timeout=120)
    assert [list(r["out"]) for r in reqs] == \
        [plain("port", p, m) for p, m in todo]
    events = [e["event"] for e in pol.journal()]
    assert events[0] == "engage_brownout_spec"
    assert brownouts.value(knob="spec") > before
    assert eng._kv.stats()["blocks_used"] == 0
    assert eng._draft._kv.stats()["blocks_used"] == 0


def test_deadline_verdicts_count_apart_from_shedding(models):
    """A 'deadline' verdict rejects the submission with its reason and
    counts as a deadline rejection, not as shed load."""
    from paddle_tpu_torch.serving_supervisor import StaticShedPolicy
    _, tm = models

    class Deadline(StaticShedPolicy):
        def admit_verdict(self, server, prompt_len, max_new, deadline):
            return "deadline"

    reg = om.default_registry().get(
        "serving.admission_deadline_rejected_total")
    before = reg.value()
    srv = GenerationServer(_port(tm), policy=Deadline())
    try:
        with pytest.raises(RuntimeError, match="reason=deadline"):
            srv.submit([1, 2, 3], 4, deadline=1.0)
        st = srv.stats()
        assert (st["deadline_rejected"], st["shed"], st["rejected"]) == \
            (1, 0, 1)
        assert reg.value() == before + 1
    finally:
        assert srv.shutdown(timeout=60)


def test_draft_stays_in_lockstep_through_prefix_hits_and_deferral(
        models, plain):
    """A block-aligned full prefix hit (copy-on-write of the last
    matched block in both pools), a draft pool that cannot cover the
    mirror (both pools defer: the target's admission is undone), and an
    eviction (released as evictions in both pools): the streams stay
    equal to plain stepping's throughout."""
    _, tm = models
    eng = _port(tm)
    prompt = list(range(10, 26))                      # two full blocks
    want = plain("port", prompt, 10)
    for _ in range(2):                                # cold, then a hit
        assert eng.generate(prompt, max_new_tokens=10) == want
    assert eng.begin_request(0, prompt, 10)
    assert eng.prefix_hit_tokens[0] == 15
    assert eng._draft.prefix_hit_tokens[0] == 15
    out = None
    while out is None:
        out = eng.prefill_chunk(0)
    toks = [out]
    while len(toks) < 10:
        t, c = eng.spec_step()
        toks.extend(int(x) for x in t[0, :int(c[0])])
        _check_pools(eng)
    assert toks[:10] == want
    evictions = (eng._kv.evictions, eng._draft._kv.evictions)
    eng.release(0, evicted=True)
    assert eng._kv.evictions > evictions[0]
    assert eng._draft._kv.evictions > evictions[1]
    assert eng._kv.stats()["blocks_used"] == 0
    # an independent draft with a smaller pool: a request it could
    # never hold raises, one it cannot hold now defers both engines
    small = PagedLlamaDecodeEngine(tm, device="cpu", num_layers=1,
                                   num_blocks=4, **GEO)
    tgt = PagedLlamaDecodeEngine(tm, device="cpu", **GEO)
    tgt.attach_draft(small, spec_tokens=3)

    def clean():
        st = tgt._kv.stats()
        assert (st["blocks_used"], st["blocks_reserved"]) == (0, 0)
        assert not tgt._kv.occupied_slots()
        tgt._kv.check_invariants()

    with pytest.raises(ValueError, match="pool holds only 4"):
        tgt.begin_request(0, list(range(1, 30)), 8)
    clean()
    assert small.begin_request(1, list(range(1, 21)), 4)   # 3 blocks
    assert not tgt.begin_request(0, [1, 2, 3], 4)          # needs 2
    clean()
    small.release(1)
    assert tgt.begin_request(0, [1, 2, 3], 4)
    tgt.release(0)
    clean()
