"""Hot start: the port's ``jit.warmup`` and the engines' warm-bundle
seams against the JAX package's.

The bundle round trip and its failure reasons (missing, corrupt,
version, a torn write through ``warmup.write``) run on both packages.
The port's engines record the same ``serving`` entries as the JAX
engines for the same geometry (decode, prefill per bucket, the spec
pair, the prefix copy-on-write; the dense engine's decode); a stale
entry is counted, not replayed; a failing entry counts as
``reason=program``; streams after ``prewarm`` equal streams without it
and pre-warm leaves the pools as they were. The executable cache's
hit/miss/write counts come from the real counting code of
``ops/kernels/build.py``, with only the ``nvcc`` command replaced by a
stub that copies a real shared library.
"""
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.jit import warmup as jwarmup
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability import metrics as jom
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.convert import load_from_jax
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.jit import warmup as twarmup
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import metrics as tom
from paddle_tpu_torch.ops.kernels import build
from paddle_tpu_torch.utils import fault_injection as tfi

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, use_flash_attention=False)
GEO = dict(max_slots=2, max_seq=64, block_size=8, prefill_chunk=16)

PKGS = {
    "jax": SimpleNamespace(name="jax", warmup=jwarmup, fi=jfi,
                           registry=jom.default_registry),
    "port": SimpleNamespace(name="port", warmup=twarmup, fi=tfi,
                            registry=tom.default_registry),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    p = PKGS[request.param]
    p.warmup.clear_recorded()
    yield p
    p.warmup.clear_recorded()
    p.fi.clear()


def _failures(p, reason):
    c = p.registry().get("warmup.failures_total")
    return 0 if c is None else c.value(reason=reason)


def test_bundle_round_trip_and_failure_reasons(pkg, tmp_path):
    """Entries round-trip through the manifest (sorted JSON, the shared
    key and version); a missing, corrupt, non-bundle or newer file loads
    as None with its counted reason; a torn write leaves no bundle."""
    w = pkg.warmup
    meta = {"program": "decode", "layout": "paged", "slots": 2}
    w.note_program("serving", "serving.paged_decode", {"meta": meta})
    w.note_program("serving", "serving.paged_decode", {"meta": meta})
    w.note_program("serving", "x", {"meta": {"f": object()}})  # skipped
    assert len(w.recorded()) == 1
    path = str(tmp_path / "b.json")
    assert w.export_bundle(path) == path
    b = w.load_bundle(path)
    assert b["__paddle_tpu_warm_bundle__"] == w.BUNDLE_VERSION == 1
    assert b["entries"] == [{"kind": "serving", "meta": meta,
                             "name": "serving.paged_decode"}]
    cases = {"missing": str(tmp_path / "nope.json")}
    (tmp_path / "bad.json").write_bytes(b"{not json")
    cases["corrupt"] = str(tmp_path / "bad.json")
    (tmp_path / "list.json").write_text(json.dumps({"entries": 3}))
    (tmp_path / "new.json").write_text(json.dumps(
        {"__paddle_tpu_warm_bundle__": 99, "entries": []}))
    for reason, p in [*cases.items(),
                      ("corrupt", str(tmp_path / "list.json")),
                      ("version", str(tmp_path / "new.json"))]:
        before = _failures(pkg, reason)
        assert w.load_bundle(p) is None
        assert _failures(pkg, reason) == before + 1, reason
    torn = str(tmp_path / "torn.json")
    pkg.fi.inject("warmup.write", truncate_at=10)
    with pytest.raises(pkg.fi.InjectedFault):
        w.export_bundle(torn)
    assert sorted(os.listdir(tmp_path)) == ["b.json", "bad.json",
                                            "list.json", "new.json"]


def test_the_two_packages_read_each_others_bundles(tmp_path):
    for src, dst in (("jax", "port"), ("port", "jax")):
        ws, wd = PKGS[src].warmup, PKGS[dst].warmup
        ws.clear_recorded()
        ws.note_program("serving", "serving.paged_prefill",
                        {"meta": {"program": "prefill", "bucket": 8}})
        path = ws.export_bundle(str(tmp_path / f"{src}.json"))
        assert wd.load_bundle(path)["entries"] == ws.recorded()
        ws.clear_recorded()


@pytest.fixture(scope="module")
def models():
    paddle.seed(17)
    jm = JaxLlama(JaxConfig.tiny(**CFG))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_from_jax(tm, {k: np.asarray(v._data)
                       for k, v in jm.named_parameters()})
    return jm, tm


def _drive(name, models, spec):
    """One run of the same traffic through a package's engines: a
    chunked prompt (buckets 16 and 8), a prefix hit with its
    copy-on-write, speculative steps when ``spec``; then the dense
    engine's generate. Returns the recorded entries (canonical JSON)."""
    jm, tm = models
    w = PKGS[name].warmup
    w.clear_recorded()
    if name == "jax":
        eng = jserving.PagedLlamaDecodeEngine(jm, **GEO)
        if spec:
            eng.attach_draft(eng.make_draft(jm, num_layers=1),
                             spec_tokens=3)
        srv = jserving.GenerationServer(eng)
        dense = jserving.LlamaDecodeEngine(jm, max_slots=2, max_seq=64)
    else:
        eng = tserving.PagedLlamaDecodeEngine(tm, device="cpu", **GEO)
        if spec:
            eng.attach_draft(eng.make_draft(num_layers=1), spec_tokens=3)
        srv = tserving.GenerationServer(eng)
        dense = tserving.LlamaDecodeEngine(tm, max_slots=2, max_seq=64,
                                           device="cpu")
    prompt = list(range(1, 25))   # 24 tokens: chunks of 16 and 8
    try:
        outs = [srv.generate(prompt, 6, timeout=60),
                srv.generate(prompt[:16], 5, timeout=60)]
    finally:
        assert srv.shutdown(timeout=60)
    outs.append(dense.generate(np.asarray([3, 4, 5]), 4))
    return sorted(json.dumps(e, sort_keys=True) for e in w.recorded()), \
        outs


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_port_engines_record_the_jax_entries(models, spec):
    jax_entries, jax_outs = _drive("jax", models, spec)
    port_entries, port_outs = _drive("port", models, spec)
    assert port_outs == jax_outs
    assert port_entries == jax_entries
    progs = {json.loads(e)["meta"]["program"] for e in port_entries}
    want = {"decode", "prefill", "prefix_cow"} | (
        {"spec_draft", "spec_verify"} if spec else set())
    assert progs == want
    buckets = sorted(json.loads(e)["meta"].get("bucket", 0)
                     for e in port_entries)
    assert {8, 16} <= set(buckets)
    layouts = {json.loads(e)["meta"]["layout"] for e in port_entries}
    assert layouts == {"paged", "dense"}


def _port_engine(tm, **kw):
    return tserving.PagedLlamaDecodeEngine(tm, device="cpu", **{**GEO, **kw})


def _entries(eng, spec=False):
    geo = eng._warm_geo()
    out = [{"kind": "serving", "name": "serving.paged_decode",
            "meta": {"program": "decode", **geo}},
           {"kind": "serving", "name": "serving.paged_prefill",
            "meta": {"program": "prefill", "bucket": 8, **geo}},
           {"kind": "captured_step", "name": "step", "sig": [1]}]
    if spec:
        out += [{"kind": "serving", "name": "serving.spec_draft",
                 "meta": {"program": "spec_draft", "k": 3,
                          "draft_layers": 1, **geo}},
                {"kind": "serving", "name": "serving.spec_verify",
                 "meta": {"program": "spec_verify", "k": 3, **geo}}]
    return {"__paddle_tpu_warm_bundle__": 1, "entries": out}


def test_stale_entry_counted_not_replayed(models):
    """An entry recorded against another pool geometry, a prefill bucket
    over the live chunk or another spec_k is counted as stale and its
    program never runs; spec entries without a draft are skipped."""
    _, tm = models
    eng = _port_engine(tm)
    bundle = _entries(_port_engine(tm, max_slots=3), spec=True)
    bundle["entries"].append(
        {"kind": "serving", "name": "serving.paged_prefill",
         "meta": {"program": "prefill", "bucket": 32, **eng._warm_geo()}})
    calls = []
    eng._forward_paged = lambda *a, **k: calls.append(a)
    before = _failures(PKGS["port"], "stale")
    got = twarmup.prewarm(bundle, engine=eng)
    assert got == {"programs": 0, "failures": 3, "skipped": 3}
    assert _failures(PKGS["port"], "stale") == before + 3
    assert calls == []
    eng2 = _port_engine(tm)
    eng2.attach_draft(eng2.make_draft(num_layers=1), spec_tokens=2)
    got = twarmup.prewarm(_entries(eng2, spec=True), engine=eng2)
    assert got == {"programs": 2, "failures": 2, "skipped": 1}


def test_a_failing_entry_counts_as_program(models):
    _, tm = models
    eng = _port_engine(tm)
    assert eng.begin_request(0, np.asarray([1, 2, 3]), 4)  # not idle
    before = _failures(PKGS["port"], "program")
    got = twarmup.prewarm(_entries(eng), engine=eng)
    assert got == {"programs": 0, "failures": 2, "skipped": 1}
    assert _failures(PKGS["port"], "program") == before + 2


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_streams_after_prewarm_equal_and_pools_untouched(models, spec):
    """Pre-warm runs each program once on the idle engine: the pools and
    block tables are as before, and the streams after it equal a fresh
    engine's."""
    _, tm = models
    prompts = [([5, 9, 11, 3, 4, 5, 6, 7, 8, 10, 2, 2], 9), ([7, 1], 6)]

    def engine():
        eng = _port_engine(tm)
        if spec:
            eng.attach_draft(eng.make_draft(num_layers=1), spec_tokens=3)
        return eng

    def streams(eng):
        srv = tserving.GenerationServer(eng)
        try:
            return [srv.generate(p, n, timeout=60) for p, n in prompts]
        finally:
            assert srv.shutdown(timeout=60)

    want = streams(engine())
    eng = engine()
    tables = eng._kv.block_tables.copy()
    got = twarmup.prewarm(_entries(eng, spec=spec), engine=eng)
    assert got == {"programs": 4 if spec else 2, "failures": 0,
                   "skipped": 1}
    assert all(int(p.abs().sum()) == 0 for pools in eng.kvs.values()
               for p in pools)
    assert np.array_equal(eng._kv.block_tables, tables)
    assert eng._kv.stats()["blocks_reserved"] == 0
    assert streams(eng) == want
    dense = tserving.LlamaDecodeEngine(tm, max_slots=2, max_seq=64,
                                       device="cpu")
    entry = {"kind": "serving", "name": "serving.decode",
             "meta": {"program": "decode", **dense._warm_geo()}}
    want_d = tserving.LlamaDecodeEngine(
        tm, max_slots=2, max_seq=64, device="cpu").generate([3, 4, 5], 5)
    assert dense._prewarm_entry(entry) is True
    assert all(int(c.abs().sum()) == 0 for c in dense.k_cache + dense.v_cache)
    assert dense.generate([3, 4, 5], 5) == want_d


@pytest.fixture()
def fake_sources(tmp_path, monkeypatch):
    """Two kernel sources, and nvcc replaced by a stub that copies a real
    shared library (so ctypes loads the "built" file)."""
    import _ctypes
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    lib = _ctypes.__file__

    def stub(src, out, verbose=False):
        return [sys.executable, "-c",
                f"import shutil; shutil.copyfile({lib!r}, {str(out)!r})"]

    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "nvcc_command", stub)
    monkeypatch.setattr(build, "nvcc_path", lambda: sys.executable)
    monkeypatch.setattr(build, "_loaded", {})
    prev = get_flags("FLAGS_executable_cache_dir")
    try:
        yield tmp_path
    finally:
        set_flags(prev)


def test_cache_counts_from_the_build(fake_sources, monkeypatch):
    """With FLAGS_executable_cache_dir set the libraries go there: the
    first load runs nvcc for every source (2 misses, 2 writes), a second
    process's load reads the library from disk (a hit); with the flag
    unset nothing counts."""
    cache = fake_sources / "cache"
    set_flags({"FLAGS_executable_cache_dir": str(cache)})
    assert twarmup.ensure_executable_cache()
    assert build.build_dir() == cache
    c0 = twarmup.cache_stats()
    build.load("a")
    c1 = twarmup.cache_stats()
    assert (c1["misses"] - c0["misses"], c1["writes"] - c0["writes"],
            c1["hits"] - c0["hits"]) == (2, 2, 0)
    assert sorted(p.name.split("_")[0] for p in cache.iterdir()) \
        == ["liba", "libb"]
    build._loaded.clear()           # a fresh process, the same directory
    build.load("a")
    build.load("b")
    build.load("b")                 # loaded already: not a disk read
    c2 = twarmup.cache_stats()
    assert (c2["misses"], c2["writes"], c2["hits"] - c1["hits"]) \
        == (c1["misses"], c1["writes"], 2)
    set_flags({"FLAGS_executable_cache_dir": ""})
    assert not twarmup.ensure_executable_cache()
    build._loaded.clear()
    monkeypatch.setenv(build.BUILD_DIR_ENV, str(fake_sources / "plain"))
    assert build.build_dir() == fake_sources / "plain"
    build.load("a")
    assert twarmup.cache_stats() == c2
    assert len(list((fake_sources / "plain").iterdir())) == 2


def test_gc_evicts_old_libraries_and_keeps_bundles(tmp_path):
    old = tmp_path / "libx_0.so"
    old.write_bytes(b"x")
    keep = tmp_path / "warm_bundle.json"
    keep.write_text("{}")
    fresh = tmp_path / "liby_0.so"
    fresh.write_bytes(b"y")
    t = time.time() - 3 * 86400
    os.utime(old, (t, t))
    os.utime(keep, (t, t))
    assert twarmup.gc_cache_dir(max_age_days=2, directory=str(tmp_path)) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) \
        == ["liby_0.so", "warm_bundle.json"]
    assert twarmup.gc_cache_dir(max_age_days=0, directory=str(tmp_path)) == 0
