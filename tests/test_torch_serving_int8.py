"""``int8=True``: the s8 projections of the port's serving engines
against the JAX package's, on the CPU.

``_quantize_w`` (per-output-channel codes and steps) is bit-equal to the
JAX one; ``_mm``'s activation codes and s8 x s8 -> s32 accumulators are
equal to JAX's ``dot_general`` on the same activations; the dense and
paged engines with ``int8=True`` give the JAX engines' greedy streams on
the same weights (the int8 case of tests/test_serving_generation.py,
and longer prompts over several prefill chunks); ``inference.serve`` and
a fleet replica take ``int8`` and serve those streams."""
import http.client
import io

import jax
import jax.numpy as jnp
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
from paddle_tpu_torch import serving_fleet as tfleet
from paddle_tpu_torch.convert import load_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from test_torch_tensor import port_on_cpu  # noqa: F401

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, use_flash_attention=False)
PAGED = dict(max_slots=2, max_seq=64, block_size=4, prefill_chunk=8)
PROMPTS = [[5, 9, 11], list(range(1, 14)), list(range(3, 33))]


@pytest.fixture(scope="module")
def models():
    paddle.seed(9)
    jm = JaxLlama(JaxConfig.tiny(**CFG))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_from_jax(tm, {k: np.asarray(v._data)
                       for k, v in jm.named_parameters()})
    return jm, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_w_is_bit_equal(dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((48, 40)).astype(np.float32) * 3
    w[5] = 0.0                       # the 1e-8 floor of an empty row
    w[7, :] = 0.5                    # a row of exact halves
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jq, jstep = jserving._quantize_w(
        np.asarray(tw.float().numpy()))
    q, step = tserving._quantize_w(tw)
    assert q.dtype == torch.int8 and step.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(step.numpy(), np.asarray(jstep))


@pytest.mark.parametrize("rows", [1, 8, 40])
def test_s8_accumulators_equal_jax_dot_general(models, rows):
    """The activation codes and the int32 accumulators of the port's
    ``_mm`` equal JAX's on the same activations (rows below and above
    the row padding of ``_s8_matmul``), and the scaled outputs agree."""
    _, tm = models
    eng = tserving.LlamaDecodeEngine(tm, 2, 32, True, device="cpu")
    w_q, w_step = eng.params["layers"][0]["gate_proj"]
    rng = np.random.default_rng(rows)
    h = rng.standard_normal((rows, w_q.shape[1])).astype(np.float32)
    step = np.maximum(np.abs(h).max(), 1e-8) / 127.0
    jqh = jnp.clip(jnp.round(jnp.asarray(h) / step), -127,
                   127).astype(jnp.int8)
    jacc = jax.lax.dot_general(jqh, jnp.asarray(w_q.numpy()),
                               (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)
    th = torch.from_numpy(h)
    tstep = torch.clamp(th.abs().amax(), min=1e-8) / 127.0
    qh = torch.clamp(torch.round(th / tstep), -127, 127).to(torch.int8)
    assert np.array_equal(qh.numpy(), np.asarray(jqh))
    acc = tserving._s8_matmul(qh, w_q)
    assert acc.dtype == torch.int32 and acc.shape == (rows, w_q.shape[0])
    assert np.array_equal(acc.numpy(), np.asarray(jacc))
    want = np.asarray(jacc).astype(np.float32) * (w_step.numpy() * step)
    np.testing.assert_allclose(eng._mm(th, (w_q, w_step)).numpy(), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_int8_engine_streams_equal_jax(models, kind):
    jm, tm = models
    if kind == "dense":
        jeng = jserving.LlamaDecodeEngine(jm, max_slots=2, max_seq=64,
                                          int8=True)
        eng = tserving.LlamaDecodeEngine(tm, max_slots=2, max_seq=64,
                                         int8=True, device="cpu")
    else:
        jeng = jserving.PagedLlamaDecodeEngine(jm, int8=True, **PAGED)
        eng = tserving.PagedLlamaDecodeEngine(tm, int8=True, device="cpu",
                                              **PAGED)
    for prompt in PROMPTS:
        want = jeng.generate(prompt, max_new_tokens=8)
        assert eng.generate(prompt, max_new_tokens=8) == want, prompt
    assert eng.generate(PROMPTS[0], 6) == eng.generate(PROMPTS[0], 6)


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


def test_serve_and_a_fleet_replica_take_int8(models, tmp_path):
    """``inference.serve(int8=True)`` and a replica process booted with
    ``"int8": True`` answer the JAX int8 engine's stream for a
    ``.pdmodel`` the JAX package saved."""
    jm, _ = models
    path = str(tmp_path / "llama")
    jinference.save_inference_model(path, jm)
    prompt, n = PROMPTS[1], 6
    geo = dict(max_slots=2, max_seq=64)
    want = jserving.PagedLlamaDecodeEngine(jm, int8=True, **geo).generate(
        np.asarray(prompt), n)
    srv = tinference.serve(path, port=0, block=False, generate=True,
                           int8=True, device="cpu", **geo)
    try:
        out = _post(srv.server_address[1], "/generate",
                    input_ids=np.asarray(prompt),
                    max_new_tokens=np.asarray(n))["output_ids"]
        assert out.tolist() == want
    finally:
        srv.shutdown(timeout=30)
    cfg = {"model": {"kind": "inference_model", "path": path},
           "device": "cpu", "int8": True, **geo}
    env = {"FLAGS_executable_cache_dir": str(tmp_path / "cache")}
    proc, port, _ = tfleet.launch_replica(cfg, env=env, timeout=40)
    try:
        cli = tfleet.ReplicaClient("127.0.0.1", port, timeout=30)
        try:
            assert cli.generate(prompt, n, timeout=30) == want
            cli._call({"op": "shutdown", "drain": True})
        finally:
            cli.close()
        assert proc.wait(timeout=20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr_log.close()
