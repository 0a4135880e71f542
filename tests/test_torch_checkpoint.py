"""Crash-safe checkpoints: the port's ``framework.checkpoint`` and
``framework.io`` against the JAX package's.

The two packages share one file format, so each must load a file the
other wrote — the v2 record with its CRC32 manifest and the legacy bare
pickle, f32 and bf16 — with equal names, dtypes and values, and write
equal manifests for the same tree. The durability contract is the JAX
module's: a kill, a truncation or an error at each ``checkpoint.*``
fault site leaves the previous file intact; ``CheckpointManager`` keeps
``keep_n`` files and walks back past damaged ones; an async save copies
its tensors before the background persist starts. A JAX Llama
checkpoint reaches the port's server through ``convert``, not raw.
"""
import os
import pickle
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.framework import checkpoint as jckpt
from paddle_tpu.framework import io as jio
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.utils import fault_injection as jfi
import paddle_tpu_torch
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.convert import load_from_jax, state_dict_from_jax
from paddle_tpu_torch.framework import checkpoint as tckpt
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils import fault_injection as tfi

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, use_flash_attention=False)
GEO = dict(max_slots=2, max_seq=64, block_size=8, prefill_chunk=8)


@pytest.fixture(autouse=True)
def clean_faults():
    tfi.clear()
    jfi.clear()
    yield
    tfi.clear()
    jfi.clear()


def _arrays(seed, n=64):
    r = np.random.default_rng(seed)
    return {"w": r.standard_normal((n, 8)).astype(np.float32),
            "b": r.standard_normal(n).astype(np.float32),
            "z": np.zeros(n, np.float32),
            "i": np.arange(n, dtype=np.int32)}


def _port_tree(seed, dtype):
    a = {k: torch.from_numpy(v.copy()) for k, v in _arrays(seed).items()}
    a["b"] = a["b"].to(dtype)
    return {"model": {"w": a["w"].to(dtype), "b": a["b"]},
            "moments": [a["z"], {"lr": 0.1}], "ids": a["i"], "step": seed}


def _jax_tree(seed, dtype):
    a = {k: paddle.to_tensor(v) for k, v in _arrays(seed).items()}
    dt = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    return {"model": {"w": a["w"].astype(dt), "b": a["b"].astype(dt)},
            "moments": [a["z"], {"lr": 0.1}], "ids": a["i"], "step": seed}


def _flat(tree, prefix=""):
    """tree path -> (dtype name, f32 numpy values) for every tensor,
    plus the plain leaves as they are."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = (str(tree.dtype).replace("torch.", ""),
                       tree.float().numpy())
    elif hasattr(tree, "_data"):  # a JAX package tensor
        out[prefix] = (str(tree.dtype).replace("paddle.", ""),
                       np.asarray(tree.astype("float32").numpy()))
    else:
        out[prefix] = tree
    return out


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if isinstance(fa[k], tuple):
            assert fa[k][0] == fb[k][0], k
            np.testing.assert_array_equal(fa[k][1], fb[k][1], err_msg=k)
        else:
            assert fa[k] == fb[k], k


def _write(pkg, version, tree, path):
    if version == 2:
        (jckpt if pkg == "jax" else tckpt).atomic_save(tree, path)
    elif pkg == "jax":
        with open(path, "wb") as f:
            pickle.dump(jio._pack(tree), f, protocol=4)
    else:
        with open(path, "wb") as f:
            f.write(tio._dumps(tio._pack(tree)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("version", [2, 1], ids=["v2", "v1"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_others_file(tmp_path, writer, version,
                                            dtype):
    """A file one package wrote loads in both: equal names, dtypes and
    values; the version each reader reports is the one written."""
    path = str(tmp_path / "ck")
    tree = (_jax_tree if writer == "jax" else _port_tree)(4, dtype)
    _write(writer, version, tree, path)
    got_port = tckpt.load_checkpoint(path, device="cpu")
    got_jax = jckpt.load_checkpoint(path)
    _assert_same(got_port, _port_tree(4, dtype))
    _assert_same(got_jax, _jax_tree(4, dtype))
    assert tckpt._read_record(path)[0] == version
    assert jckpt._read_record(path)[0] == version
    assert tckpt.verify_checkpoint(path) == (True, "")
    assert jckpt.verify_checkpoint(path) == (True, "")
    np_got = tckpt.load_checkpoint(path, return_numpy=True)
    assert np_got["model"]["w"].dtype == np.float32  # bf16 widened
    np.testing.assert_array_equal(np_got["ids"], np.arange(64))


def test_manifests_equal_between_packages(tmp_path):
    """The same tree gives the same manifest (paths, CRC32s, byte
    counts, shapes, dtype names) from either writer."""
    manifests = []
    for pkg, mod, tree in (("jax", jckpt, _jax_tree(2, torch.bfloat16)),
                           ("port", tckpt, _port_tree(2, torch.bfloat16))):
        path = str(tmp_path / pkg)
        mod.atomic_save(tree, path)
        manifests.append(mod._read_record(path)[1])
    assert manifests[0] == manifests[1]
    assert set(manifests[1]) == {"/model/w", "/model/b", "/moments[0]", "/ids"}
    assert manifests[1]["/model/b"]["dtype"] == "bfloat16"


def test_save_and_load_on_the_package(tmp_path):
    """``paddle_tpu_torch.save`` / ``load`` bind lazily and write the
    versioned record; ``load`` takes ``device`` through its configs."""
    path = str(tmp_path / "m.pdparams")
    paddle_tpu_torch.save(_port_tree(1, torch.float32), path)
    with open(path, "rb") as f:
        record = tio._load_pickle(f)
    assert record[tckpt.FORMAT_KEY] == 2 and record["manifest"]
    _assert_same(paddle_tpu_torch.load(path, device="cpu"),
                 _port_tree(1, torch.float32))


def test_reader_refuses_other_jax_classes(tmp_path):
    """Only the payload's class path maps to the port; any other class
    of the JAX package is refused, not imported."""
    path = str(tmp_path / "other")
    with open(path, "wb") as f:
        f.write(pickle.PROTO + b"\x02" + pickle.GLOBAL
                + b"paddle_tpu.framework.checkpoint\nCheckpointManager\n"
                + pickle.STOP)
    ok, why = tckpt.verify_checkpoint(path)
    assert not ok and "UnpicklingError" in why


def test_future_version_refused(tmp_path):
    path = str(tmp_path / "future")
    with open(path, "wb") as f:
        pickle.dump({tckpt.FORMAT_KEY: 99, "manifest": {}, "payload": {}},
                    f)
    with pytest.raises(tckpt.CheckpointCorruptError, match="version"):
        tckpt.load_checkpoint(path, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_corruption_raises(tmp_path, writer):
    """One flipped byte inside a tensor: the pickle still decodes, the
    manifest refuses the data — in a file of either package."""
    path = str(tmp_path / "ck")
    if writer == "jax":
        jckpt.atomic_save({"w": paddle.to_tensor(
            np.full((32,), 2.0, np.float32))}, path)
    else:
        tckpt.atomic_save({"w": torch.full((32,), 2.0)}, path)
    blob = bytearray(open(path, "rb").read())
    idx = blob.rfind(np.float32(2.0).tobytes())
    blob[idx] ^= 0x55
    with open(path, "wb") as f:
        f.write(bytes(blob))
    ok, why = tckpt.verify_checkpoint(path)
    assert not ok and "crc32" in why
    with pytest.raises(tckpt.CheckpointCorruptError, match="corrupt"):
        tckpt.load_checkpoint(path, device="cpu")
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    ok, why = tckpt.verify_checkpoint(path)
    assert not ok and "unreadable" in why


# ---------------------------------------------------------------------------
# the fault sites
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site,arm,tmp_left", [
    ("checkpoint.snapshot", dict(kill=True), False),
    ("checkpoint.snapshot", dict(exc=OSError("EIO")), False),
    ("checkpoint.write", dict(truncate_at=64, kill=True), True),
    ("checkpoint.write", dict(truncate_at=64), False),
    ("checkpoint.write", dict(exc=OSError("ENOSPC")), False),
    ("checkpoint.rename", dict(kill=True), True),
    ("checkpoint.rename", dict(exc=OSError("EXDEV")), False),
], ids=["snapshot-kill", "snapshot-error", "write-truncate-kill",
        "write-truncate", "write-error", "rename-kill", "rename-error"])
def test_fault_sites_keep_the_previous_file(tmp_path, site, arm, tmp_left):
    """A kill, a truncation or an error at each site: the previous
    complete file stays at the final path; a kill leaves its temp file
    behind as a preemption would, an error cleans it up."""
    path = str(tmp_path / "ck")
    tckpt.atomic_save(_port_tree(1, torch.float32), path)
    fired = tfi.stats().get(site, 0)
    tfi.inject(site, **arm)
    want = tfi.KillPoint if arm.get("kill") else (OSError, tfi.InjectedFault)
    with pytest.raises(want):
        tckpt.atomic_save(_port_tree(2, torch.float32), path)
    assert tfi.stats()[site] == fired + 1
    assert any(".tmp." in n for n in os.listdir(tmp_path)) == tmp_left
    assert tckpt.verify_checkpoint(path) == (True, "")
    _assert_same(tckpt.load_checkpoint(path, device="cpu"),
                 _port_tree(1, torch.float32))


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def test_retention_and_numbering(tmp_path):
    m = tckpt.CheckpointManager(str(tmp_path), keep_n=2)
    for s in range(5):
        m.save(_port_tree(s, torch.float32), step=s)
    assert m.steps() == [3, 4]
    assert m.stats()["retired"] == 3
    m2 = tckpt.CheckpointManager(str(tmp_path), keep_n=5)
    m2.save(_port_tree(5, torch.float32))
    assert m2.steps() == [3, 4, 5]


def test_latest_walks_back_past_damage(tmp_path):
    """A save killed mid-write leaves no file; a newest file truncated
    by ``write_bytes`` and one with a flipped byte are skipped, counted
    and journaled: latest() and restore() land on the newest good
    step."""
    tflight.clear()
    m = tckpt.CheckpointManager(str(tmp_path), keep_n=5)
    m.save(_port_tree(0, torch.float32), step=0)
    m.save(_port_tree(1, torch.float32), step=1)
    tfi.inject("checkpoint.write", truncate_at=100, kill=True)
    with pytest.raises(tfi.KillPoint):
        m.save(_port_tree(2, torch.float32), step=2)
    assert m.latest_step() == 1
    blob = open(m._path(1), "rb").read()
    tfi.inject("test.torn", truncate_at=len(blob) // 3)
    with open(m._path(3), "wb") as f:
        with pytest.raises(tfi.InjectedFault):
            tfi.write_bytes("test.torn", f, blob)
    flipped = bytearray(blob)
    flipped[-40] ^= 0xFF
    with open(m._path(4), "wb") as f:
        f.write(bytes(flipped))
    assert m.latest_step() == 1
    assert m.stats()["corrupt_skipped"] == 2
    step, got = m.restore(device="cpu")
    assert step == 1
    _assert_same(got, _port_tree(1, torch.float32))
    names = [e["attrs"]["where"] for e in tflight.events(
        category="checkpoint") if e["name"] == "corrupt_fallback"]
    assert names == ["latest", "latest", "restore", "restore"]
    assert tckpt.CheckpointManager(str(tmp_path / "empty")).restore() \
        is None


def test_async_save_copies_before_the_persist(tmp_path, monkeypatch):
    """An optimizer step taken while the async persist is still held
    back does not reach the file: the snapshot is the values at
    ``save()``. The persist's failure surfaces at the next barrier."""
    model = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    opt = AdamW(learning_rate=0.1, parameters=list(model.parameters()))
    gate = threading.Event()
    persist = tckpt._persist_packed

    def held(*a, **k):
        assert gate.wait(30)
        return persist(*a, **k)

    monkeypatch.setattr(tckpt, "_persist_packed", held)
    m = tckpt.CheckpointManager(str(tmp_path), async_save=True)
    want = {k: v.detach().clone() for k, v in model.state_dict().items()}
    m.save({"model": model.state_dict()}, step=0)
    loss = model(torch.arange(8)[None]).float().square().mean()
    loss.backward()
    opt.step()
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, want[k])]
    assert moved
    gate.set()
    m.wait()
    assert m.stats()["async_saves"] == 1 and m.stats()["saves"] == 1
    step, got = m.restore(device="cpu")
    assert step == 0
    for k, v in got["model"].items():
        assert torch.equal(v, want[k]), k
    tfi.inject("checkpoint.write", exc=OSError("disk gone"))
    m.save({"model": model.state_dict()}, step=1)
    with pytest.raises(OSError, match="disk gone"):
        m.wait()
    m.close()


# ---------------------------------------------------------------------------
# a JAX Llama checkpoint into the port's server
# ---------------------------------------------------------------------------

def test_jax_llama_checkpoint_into_a_port_swap(tmp_path):
    """A JAX-written Llama checkpoint, loaded by the port and carried
    through ``state_dict_from_jax``, swaps into a port server: its
    streams equal the JAX server's after the JAX server swapped from the
    same path. Passed raw, the JAX layout ([in, out]: gate_proj is not
    square) is rejected with the old weights intact."""
    paddle.seed(7)
    jm_a = JaxLlama(JaxConfig.tiny(**CFG))
    paddle.seed(29)
    jm_b = JaxLlama(JaxConfig.tiny(**CFG))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_from_jax(tm, {k: np.asarray(v._data)
                       for k, v in jm_a.named_parameters()})
    path = str(tmp_path / "b.pdckpt")
    jckpt.atomic_save({"model": dict(jm_b.named_parameters()), "step": 9},
                      path)
    jsrv = jserving.GenerationServer(jserving.PagedLlamaDecodeEngine(
        jm_a, **GEO))
    eng = tserving.PagedLlamaDecodeEngine(tm, device="cpu", **GEO)
    tsrv = tserving.GenerationServer(eng)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    try:
        before = [tsrv.generate(p, 6, timeout=60) for p in prompts]
        assert before == [jsrv.generate(p, 6, timeout=60) for p in prompts]
        old = eng.params
        with pytest.raises(ValueError, match="weight swap rejected"):
            tsrv.swap_weights(path, timeout=60)
        assert eng.params is old
        assert [tsrv.generate(p, 6, timeout=60) for p in prompts] == before
        jsrv.swap_weights(path, timeout=60)
        arrays = tckpt.load_checkpoint(path, return_numpy=True)["model"]
        tsrv.swap_weights(state_dict_from_jax(arrays, tm), timeout=60)
        after = [tsrv.generate(p, 6, timeout=60) for p in prompts]
        assert after == [jsrv.generate(p, 6, timeout=60) for p in prompts]
        assert after != before
        assert tsrv.stats()["weight_swaps"] == 1
    finally:
        assert tsrv.shutdown(timeout=60)
        jsrv.shutdown(timeout=60)
