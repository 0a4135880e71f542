"""The inference front end: the port's ``inference`` against the JAX
package's.

The scenarios of tests/test_inference.py that need no AOT export run on
the port (save/load round trip, the predictor against the eager forward,
mismatched files, input names, live modules and their modes, bf16 kept
through a load, unreconstructable models refused at save). A
``.pdmodel`` the JAX package saved for its Llama loads into the port's
and generates the JAX engine's greedy stream; ``aot=True`` and
``int8=True`` raise; ``serve`` on an ephemeral port answers ``/run``,
``/generate`` and ``/health``, micro-batches concurrent requests and
stops its threads.
"""
import dataclasses
import http.client
import io
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu import serving as jserving
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.convert import llama_config_from_jax
from paddle_tpu_torch.framework.io import load as tload
from paddle_tpu_torch.framework.io import save as tsave
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, use_flash_attention=False)


def _model(seed=0, **kw):
    return LlamaForCausalLM(
        LlamaConfig.tiny(**{**CFG, **kw}), device="cpu",
        generator=torch.Generator().manual_seed(seed))


def _logits(m, ids):
    with torch.no_grad():
        return m(torch.as_tensor(ids)).float().numpy()


def test_save_load_roundtrip(tmp_path, rng):
    m = _model(0).eval()
    path = str(tmp_path / "llama")
    tinference.save_inference_model(path, m)
    m2 = tinference.load_inference_model(path, device="cpu")
    assert not m2.training
    ids = rng.integers(0, 64, (1, 8))
    np.testing.assert_array_equal(_logits(m, ids), _logits(m2, ids))


def test_predictor_matches_eager(tmp_path, rng):
    m = _model(1).eval()
    path = str(tmp_path / "llama")
    tinference.save_inference_model(path, m)
    cfg = tinference.Config(path)
    cfg.disable_gpu()
    pred = tinference.create_predictor(cfg)
    ids = rng.integers(0, 64, (2, 8)).astype(np.int32)
    out = pred.run(ids)
    np.testing.assert_allclose(out[0], _logits(m, ids), atol=1e-6)
    np.testing.assert_array_equal(pred.run(ids)[0], out[0])
    assert pred.predict(ids)[0].shape == (2, 8, 64)


def test_load_mismatched_model_raises(tmp_path):
    """A rebuilt module whose parameters do not match the file raises
    instead of serving random weights."""
    path = str(tmp_path / "m")
    tinference.save_inference_model(path, _model(0))
    payload = tload(path + ".pdmodel", device="cpu")
    payload["init_config"] = LlamaConfig.tiny(**{**CFG, "hidden_size": 16})
    tsave(payload, path + ".pdmodel")
    with pytest.raises(ValueError, match="does not match"):
        tinference.load_inference_model(path, device="cpu")
    payload["init_config"] = LlamaConfig.tiny(
        **{**CFG, "num_hidden_layers": 3})
    tsave(payload, path + ".pdmodel")
    with pytest.raises(ValueError, match="missing"):
        tinference.load_inference_model(path, device="cpu")


def test_input_names_from_signature():
    assert tinference.Predictor(_model(0)).get_input_names() \
        == ["input_ids"]


def test_predictor_from_live_model(rng):
    m = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                            torch.nn.Linear(8, 2))
    pred = tinference.Predictor(m)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    with torch.no_grad():
        want = m(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(pred.run(x)[0], want, atol=1e-6)
    assert m.training  # building or running a predictor keeps the mode


def test_save_unreconstructable_model_raises_at_save(tmp_path):
    for bad in (torch.nn.Linear(4, 2),
                torch.nn.Sequential(torch.nn.Linear(4, 2))):
        with pytest.raises(ValueError, match="config"):
            tinference.save_inference_model(str(tmp_path / "bad"), bad)


def test_predictor_preserves_mixed_sublayer_modes(rng):
    """The forward runs in eval mode (dropout off) and each module's own
    mode comes back afterwards."""
    m = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Dropout(0.5))
    m.train()
    m[1].training = False
    x = rng.normal(size=(2, 4)).astype(np.float32)
    out = tinference.Predictor(m).run(x)[0]
    assert m.training and m[0].training and not m[1].training
    with torch.no_grad():
        want = m[0](torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(out, want)


def test_bf16_dtype_preserved_through_load(tmp_path, rng):
    m = _model(4, dtype="bfloat16")
    path = str(tmp_path / "bf16model")
    tinference.save_inference_model(path, m)
    m2 = tinference.load_inference_model(path, device="cpu")
    assert m2.lm_head.weight.dtype == torch.bfloat16
    out = tinference.Predictor(m2).run(rng.integers(0, 64, (1, 5)))[0]
    assert out.dtype == np.float32  # bf16 widened exactly for numpy


def test_aot_and_int8_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="aot"):
        tinference.save_inference_model(str(tmp_path / "x"), _model(0),
                                        aot=True)
    path = str(tmp_path / "m")
    tinference.save_inference_model(path, _model(0))
    with pytest.raises(NotImplementedError, match="s8"):
        tinference.serve(path, port=0, block=False, generate=True,
                         int8=True, device="cpu")


# ---------------------------------------------------------------------------
# a .pdmodel the JAX package saved
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_llama():
    paddle.seed(5)
    return JaxLlama(JaxConfig.tiny(**CFG))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_jax_pdmodel_loads_and_generates(jax_llama, tmp_path, rng, bf16):
    """The JAX package's file for its Llama rebuilds the port's Llama
    (config mapped, projections transposed, the file's dtype kept): the
    logits agree with the JAX forward and, in f32, the paged engine's
    greedy stream equals the JAX engine's."""
    jm = jax_llama
    if bf16:
        paddle.seed(6)
        jm = JaxLlama(JaxConfig.tiny(**CFG))
        jm.bfloat16()
    path = str(tmp_path / "jax")
    jinference.save_inference_model(path, jm)
    tm = tinference.load_inference_model(path, device="cpu")
    assert isinstance(tm, LlamaForCausalLM)
    dt = "bfloat16" if bf16 else "float32"
    assert tm.config == dataclasses.replace(
        llama_config_from_jax(vars(jm.config)), dtype=dt)
    assert tm.lm_head.weight.dtype == getattr(torch, dt)
    ids = rng.integers(0, 64, (2, 7)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids)).astype("float32").numpy())
    tol = 2e-2 if bf16 else 1e-5
    np.testing.assert_allclose(_logits(tm, ids), want, atol=tol, rtol=tol)
    if not bf16:
        geo = dict(max_slots=2, max_seq=64, block_size=8, prefill_chunk=8)
        prompt = [5, 9, 11, 3, 4, 5, 6, 7, 8, 10]
        jstream = jserving.PagedLlamaDecodeEngine(jm, **geo).generate(
            np.asarray(prompt), 12)
        tstream = tserving.PagedLlamaDecodeEngine(
            tm, device="cpu", **geo).generate(np.asarray(prompt), 12)
        assert tstream == jstream
        np.testing.assert_allclose(
            tinference.Predictor(tinference.Config(path), device="cpu")
            .run(ids)[0], want, atol=1e-5)


def test_jax_files_the_port_cannot_load_raise(jax_llama, tmp_path):
    """A JAX config with a feature the port lacks, and a JAX class with
    no port counterpart, raise rather than load something else."""
    with pytest.raises(ValueError, match="recompute"):
        llama_config_from_jax({**CFG, "recompute": True})
    assert llama_config_from_jax({**CFG, "cp_mesh": None,
                                  "sequence_parallel": False}) \
        == LlamaConfig(**CFG)
    path = str(tmp_path / "bert")
    tsave({"state_dict": {}, "module": "paddle_tpu.models.bert",
           "class_name": "BertForMaskedLM", "init_config": None,
           "input_spec": []}, path + ".pdmodel")
    with pytest.raises(ValueError, match="no port counterpart"):
        tinference.load_inference_model(path, device="cpu")


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

class _BatchToy(torch.nn.Module):
    """Module-level so the artifact's factory re-imports."""

    def __init__(self, config=None):
        super().__init__()
        self.config = config
        self.fc = torch.nn.Sequential(torch.nn.Linear(8, 16),
                                      torch.nn.Tanh(),
                                      torch.nn.Linear(16, 4))

    def forward(self, x):
        return self.fc(x)


def _post(port, path, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=buf.getvalue())
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    assert resp.status == 200, body
    return np.load(io.BytesIO(body))


def _serve_threads():
    return [t for t in threading.enumerate()
            if t.name in ("inference-http", "inference-batcher")
            and t.is_alive()]


def test_serve_answers_run_generate_and_health(tmp_path, rng):
    m = _model(8).eval()
    path = str(tmp_path / "llama")
    tinference.save_inference_model(path, m)
    srv = tinference.serve(path, port=0, block=False, generate=True,
                           max_slots=2, max_seq=64, device="cpu",
                           supervised=True)
    port = srv.server_address[1]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/health")
        assert conn.getresponse().read() == b"ok"
        conn.close()
        ids = rng.integers(0, 64, (1, 6)).astype(np.int32)
        got = _post(port, "/run", input_0=ids)["output_0"]
        np.testing.assert_allclose(got, _logits(m, ids), atol=1e-6)
        prompt = [3, 1, 4, 1, 5]
        want = tserving.PagedLlamaDecodeEngine(
            m, max_slots=2, max_seq=64, device="cpu").generate(
                np.asarray(prompt), 7)
        out = _post(port, "/generate", input_ids=np.asarray(prompt),
                    max_new_tokens=np.asarray(7))["output_ids"]
        assert out.tolist() == want
        assert srv.gen_server._supervisor is not None
    finally:
        srv.shutdown(timeout=30)
    assert not _serve_threads()
    assert not srv.gen_server._thread.is_alive()


def test_concurrent_requests_batch_into_fewer_dispatches(tmp_path):
    m = _BatchToy()
    path = str(tmp_path / "toy")
    tinference.save_inference_model(path, m)
    srv = tinference.serve(path, port=0, block=False, max_batch=16,
                           batch_window_ms=100.0, device="cpu")
    port = srv.server_address[1]
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2, 8)).astype(np.float32) for _ in range(8)]
    results, errors = [None] * 8, []

    def post(i):
        try:
            results[i] = _post(port, "/run", input_0=xs[i])["output_0"]
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    try:
        post(0)
        before = srv.batcher.batches_run
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        assert not errors, errors
        for i in range(8):
            with torch.no_grad():
                want = m(torch.as_tensor(xs[i])).numpy()
            np.testing.assert_allclose(results[i], want, rtol=1e-5,
                                       atol=1e-6)
        assert srv.batcher.batches_run - before < 8
        assert srv.batcher.requests_served >= 9
    finally:
        srv.shutdown(timeout=30)
    assert not _serve_threads()
