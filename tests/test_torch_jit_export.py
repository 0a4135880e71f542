"""The port's inference artifact (``save_inference_model(aot=True)``,
``jit.load`` / ``TranslatedLayer``, the AOT ``Predictor``) against the
JAX package's, on the CPU.

Each model is built by the JAX package, exported with its ``jax.export``
AOT path, and copied into the port through ``convert``; the port exports
its own with ``torch.export`` (a functional program over ``(params,
buffers, *inputs)``, the flash forward kept as the
``paddle_tpu_torch::flash_fwd`` operator). Both predictors serve the same
numpy input: outputs within 1e-5 + 1e-5·|ref| (f32). The models: a toy
MLP, a tiny Llama (through ``TranslatedLayer`` on both sides), a tiny GPT
and ResNet-18 at 32² (the JAX ResNet has no ``.config``: the test gives
it one so that the JAX save accepts it). A child process whose payload
names a module that does not exist serves the port's artifact; the
errors (no ``input_spec``, a dynamic dimension, ``train()``, a JAX
StableHLO payload) and the program's size are checked. Five
``torch.export`` calls in all.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import inference as jinf
from paddle_tpu.jit.api import InputSpec as JSpec
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import convert
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.framework.checkpoint import load_checkpoint
from paddle_tpu_torch.framework.io import save as tsave
from paddle_tpu_torch.jit import InputSpec, TranslatedLayer
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from test_torch_tensor import port_on_cpu  # noqa: F401

ATOL = RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class JaxToy(jpaddle.nn.Layer):
    def __init__(self, config=None):
        super().__init__()
        self.config = config
        self.fc = jpaddle.nn.Sequential(jpaddle.nn.Linear(8, 16),
                                        jpaddle.nn.Tanh(),
                                        jpaddle.nn.Linear(16, 4))

    def forward(self, x):
        return self.fc(x)


class PortToy(tpaddle.nn.Layer):
    def __init__(self, config=None):
        super().__init__()
        self.config = config
        self.fc = tpaddle.nn.Sequential(tpaddle.nn.Linear(8, 16),
                                        tpaddle.nn.Tanh(),
                                        tpaddle.nn.Linear(16, 4))

    def forward(self, x):
        return self.fc(x)


def _arrays(jm):
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


def _jax_run(tmp_path, name, jm, spec, x):
    path = str(tmp_path / f"jax_{name}")
    jinf.save_inference_model(path, jm, input_spec=[spec], aot=True)
    return path, jinf.Predictor(jinf.Config(path)).run(x)[0]


def _port_predictor(path):
    cfg = tinf.Config(path)
    cfg.disable_gpu()
    return tinf.Predictor(cfg)


def _toy(tmp_path):
    jpaddle.seed(0)
    jm = JaxToy()
    x = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    jpath, jout = _jax_run(tmp_path, "toy", jm, JSpec([3, 8], "float32"), x)
    tm = PortToy()
    tm.set_state_dict(_arrays(jm))
    path = str(tmp_path / "port_toy")
    tinf.save_inference_model(path, tm, input_spec=[InputSpec([3, 8])],
                              aot=True)
    return path, jpath, x, jout, tm


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    prev = tpaddle.core.device._current
    tpaddle.set_device("cpu")
    try:
        yield _toy(tmp_path_factory.mktemp("toy"))
    finally:
        tpaddle.core.device._current = prev


def test_toy_mlp_matches_jax(toy):
    path, _, x, jout, _ = toy
    pred = _port_predictor(path)
    assert pred._aot is not None and pred.get_input_names() == ["input_0"]
    np.testing.assert_allclose(pred.run(x)[0], jout, atol=ATOL, rtol=RTOL)


def test_program_holds_no_weights(toy):
    import io
    path, _, _, _, tm = toy
    payload = load_checkpoint(path + ".pdmodel", device="cpu")
    aot = payload["aot"]
    assert aot["format"] == "torch.export"
    assert aot["param_keys"] == sorted(
        k for k, _ in torch.nn.Module.named_parameters(tm))
    ep = torch.export.load(io.BytesIO(aot["blob"]))
    assert not ep.state_dict and not ep.constants
    assert getattr(ep, "example_inputs", None) is None
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in torch.nn.Module.parameters(tm))
    # the weights are not in the blob: they would be its ~2.3 KB of
    # float data; the program alone is bytes of graph
    blob = aot["blob"]
    w = tm.fc[0].weight.numpy().astype(np.float32).tobytes()
    assert w[:64] not in blob and weight_bytes > 0


def test_child_without_the_class_serves_it(toy, tmp_path):
    path, _, x, jout, _ = toy
    payload = load_checkpoint(path + ".pdmodel", device="cpu")
    payload["module"] = "nonexistent_module_xyz"
    hidden = str(tmp_path / "hidden")
    tsave(payload, hidden + ".pdmodel")
    np.save(str(tmp_path / "x.npy"), x)
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device('cpu')\n"
        "tl = paddle.jit.load(sys.argv[1])\n"
        "out = tl(np.load(sys.argv[2]))\n"
        "print(json.dumps({'type': type(tl).__name__,\n"
        "                  'out': out.numpy().tolist(),\n"
        "                  'toy': [m for m in sys.modules if 'test_torch' in m]}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code, hidden,
                           str(tmp_path / "x.npy")], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["type"] == "TranslatedLayer" and got["toy"] == []
    np.testing.assert_allclose(np.asarray(got["out"], np.float32), jout,
                               atol=ATOL, rtol=RTOL)


def test_llama_translated_layer_matches_jax(tmp_path):
    from paddle_tpu.jit import TranslatedLayer as JTL
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    jpaddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig.tiny())
    jm.eval()
    ids = np.random.default_rng(0).integers(0, 128, (1, 8)) \
        .astype(np.int32)
    jpath = str(tmp_path / "jax_llama")
    jinf.save_inference_model(jpath, jm, input_spec=[JSpec([1, 8], "int32")],
                              aot=True)
    jout = JTL.load(jpath)(jpaddle.to_tensor(ids)).numpy()
    from paddle_tpu_torch.models.llama import LlamaForCausalLM as TLlama
    tm = TLlama(convert.llama_config_from_jax(jm.config), device="cpu")
    convert.load_from_jax(tm, _arrays(jm))
    path = str(tmp_path / "port_llama")
    tinf.save_inference_model(path, tm, input_spec=[InputSpec([1, 8],
                                                              "int32")],
                              aot=True)
    tl = TranslatedLayer.load(path)
    np.testing.assert_allclose(tl(ids).numpy(), jout, atol=ATOL, rtol=RTOL)
    with pytest.raises(RuntimeError, match="train"):
        tl.train()
    assert tl.eval() is tl


def test_gpt_and_resnet18_match_jax(tmp_path):
    from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu.vision.models import resnet18
    jpaddle.seed(0)
    jg = GPTForCausalLM(GPTConfig(vocab_size=128, hidden_size=128,
                                  num_hidden_layers=2,
                                  num_attention_heads=2,
                                  max_position_embeddings=64))
    jg.eval()
    ids = np.random.default_rng(1).integers(0, 128, (2, 16))
    _, jout = _jax_run(tmp_path, "gpt", jg, JSpec([2, 16], "int64"), ids)
    tg = convert.gpt_from_jax(jg.config, _arrays(jg), device="cpu")
    tg.eval()
    path = str(tmp_path / "port_gpt")
    tinf.save_inference_model(path, tg, input_spec=[InputSpec([2, 16],
                                                              "int64")],
                              aot=True)
    np.testing.assert_allclose(_port_predictor(path).run(ids)[0], jout,
                               atol=ATOL, rtol=RTOL)

    jpaddle.seed(0)
    jr = resnet18(num_classes=10)
    jr.eval()
    jr.config = {"arch": "resnet18"}     # the JAX save's factory check
    x = np.random.default_rng(2).standard_normal((2, 3, 32, 32)) \
        .astype(np.float32)
    _, jout = _jax_run(tmp_path, "resnet", jr, JSpec([2, 3, 32, 32]), x)
    tr = convert.resnet_from_jax("resnet18", _arrays(jr), device="cpu",
                                 num_classes=10)
    tr.eval()
    path = str(tmp_path / "port_resnet")
    tinf.save_inference_model(path, tr, input_spec=[InputSpec(
        [2, 3, 32, 32])], aot=True)
    np.testing.assert_allclose(_port_predictor(path).run(x)[0], jout,
                               atol=ATOL, rtol=RTOL)
    # the artifact is served through its program: the class's missing
    # config does not stop jit.load
    assert isinstance(tpaddle.jit.load(path), TranslatedLayer)


def test_aot_needs_static_input_spec(tmp_path):
    m = PortToy()
    with pytest.raises(ValueError, match="input_spec"):
        tinf.save_inference_model(str(tmp_path / "a"), m, aot=True)
    with pytest.raises(ValueError, match="fully-static"):
        tinf.save_inference_model(str(tmp_path / "b"), m, input_spec=[
            InputSpec([None, 8])], aot=True)
    with pytest.raises(ValueError, match="fully-static"):
        tinf.save_inference_model(str(tmp_path / "c"), m, input_spec=[
            InputSpec([-1, 8])], aot=True)


def test_aot_rejects_bf16_recast(toy):
    cfg = tinf.Config(toy[0])
    cfg.disable_gpu()
    cfg.enable_bf16()
    with pytest.raises(ValueError, match="enable_bf16"):
        tinf.Predictor(cfg)


def test_jax_stablehlo_payload(toy, tmp_path):
    """A JAX AOT payload holds a StableHLO program: a class the port maps
    (Llama) loads through the mapping, any other raises."""
    _, jpath, _, _, _ = toy
    with pytest.raises(ValueError, match="StableHLO"):
        _port_predictor(jpath)
    with pytest.raises(ValueError, match="StableHLO"):
        tpaddle.jit.load(jpath)
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    jpaddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig.tiny())
    jm.eval()
    ids = np.random.default_rng(3).integers(0, 128, (1, 8)) \
        .astype(np.int32)
    # the StableHLO blob is never run here: its bytes stand in for one
    jpath = str(tmp_path / "jax_llama_aot")
    jinf.save_inference_model(jpath, jm)
    payload = jpaddle.load(jpath + ".pdmodel", return_numpy=False)
    payload["aot"] = {"blob": b"stablehlo", "param_keys": [],
                      "buffer_keys": []}
    jpaddle.save(payload, jpath + ".pdmodel")
    pred = _port_predictor(jpath)
    assert pred._aot is None
    want = jm(jpaddle.to_tensor(ids)).numpy()
    np.testing.assert_allclose(pred.run(ids)[0], want, atol=ATOL,
                               rtol=RTOL)


def test_jit_load_of_a_legacy_pdparams_raises(tmp_path):
    path = str(tmp_path / "w")
    tsave({"w": torch.zeros(2)}, path + ".pdparams")
    with pytest.raises(ValueError, match="legacy"):
        tpaddle.jit.load(path)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seg", [False, True])
def test_flash_operator_is_the_plain_walk_on_the_cpu(causal, seg):
    rng = np.random.default_rng(4)
    qkv = torch.as_tensor(rng.standard_normal((2, 48, 3 * 2 * 64))
                          .astype(np.float32))
    q, k, v = (x.view(2, 48, 2, 64) for x in qkv.split(128, dim=-1))
    ids = torch.as_tensor(np.repeat(np.arange(3), 16)[None].repeat(2, 0)
                          .astype(np.int32)) if seg else None
    out, lse = torch.ops.paddle_tpu_torch.flash_fwd(
        q, k, v, causal, None, 0.0, None, ids, None)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                        seg=ids)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert out.is_contiguous()
    # the fake kernel gives the shapes an exported program sees
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        fo, fl = fa.flash_fwd_op(fq, fk, fv, causal, None, 0.0, None,
                                 None, None)
    assert fo.shape == out.shape and fl.shape == lse.shape
    assert fl.dtype == torch.float32
