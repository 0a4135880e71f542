"""The PyTorch port stands alone: no JAX, no ``paddle_tpu``, and the
card unless the CPU is asked for by name."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "paddle_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu"}
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_tops(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield (node.module or "").split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [(name, line) for name, line in _imported_tops(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_covers_the_slice_modules():
    want = {"core/flags.py", "core/device.py", "observability/metrics.py",
            "observability/flight.py", "analysis/locks.py",
            "serving_supervisor.py", "nn/functional/attention.py",
            "models/llama.py", "convert.py", "ops/kernels/build.py",
            "ops/kernels/paged_attention.py", "serving_cache.py",
            "serving.py", "ops/kernels/flash_attention.py",
            "ops/fused_ce.py", "optimizer/optimizer.py", "jit/api.py",
            # the BERT MLM slice
            "core/random.py", "nn/functional/common.py",
            "nn/functional/activation.py", "nn/functional/norm.py",
            "nn/functional/loss.py", "nn/layers_common.py",
            "nn/layers_conv_norm.py", "nn/layers_loss.py",
            "nn/transformer.py", "models/bert.py",
            # the ERNIE-MoE slice and the grouped-matmul op
            "ops/kernels/grouped_matmul.py", "incubate/moe_dispatch.py",
            "incubate/moe.py", "models/gpt.py", "models/ernie_moe.py",
            # the optimizer plane
            "optimizer/lr.py", "optimizer/extra.py",
            "optimizer/fused_step.py", "regularizer.py",
            "utils/clip_grad.py", "amp/grad_scaler.py",
            "ops/kernels/multi_tensor.py",
            # the self-healing serving plane
            "utils/backoff.py", "utils/fault_injection.py",
            "observability/__main__.py", "framework/__init__.py",
            "framework/io.py", "framework/checkpoint.py",
            # the serving fleet and the inference front end
            "jit/warmup.py", "serving_fleet.py", "inference.py",
            # the paddle-API eager core and GPT on it
            "core/dtype.py", "core/tensor.py", "core/autograd.py",
            "ops/op_registry.py", "ops/creation.py", "ops/math.py",
            "ops/manipulation.py", "ops/linalg.py", "ops/inplace.py",
            "nn/initializer.py", "nn/layer.py", "nn/container.py",
            # the high-level trainer
            "amp/auto_cast.py", "nn/layers_activation.py",
            "io/__init__.py", "io/dataset.py", "io/sampler.py",
            "io/dataloader.py", "io/worker.py", "metric/__init__.py",
            "observability/timeline.py", "hapi/__init__.py",
            "hapi/callbacks.py", "hapi/model.py", "callbacks.py",
            "jit/sot.py", "ops/kernels/counters.py"}
    have = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert want <= have, sorted(want - have)
    assert (PKG / "ops" / "ops.yaml").is_file()
    for src in ("paged_attention.cu", "flash_attention.cuh",
                "flash_attention_bf16_d64.cu", "flash_attention_bf16_d128.cu",
                "flash_attention_f32_d64.cu", "flash_attention_f32_d128.cu",
                "grouped_matmul.cu", "multi_tensor_optimizer.cu"):
        assert (PKG / "ops/kernels/csrc" / src).is_file()


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter with only the repo on its path imports the
    paddle-API top level (``import paddle_tpu_torch as paddle``), the
    serving, Llama, BERT, ERNIE-MoE and GPT training stacks, the
    grouped matmul op, the optimizer plane, the fleet, the inference
    front end and the high-level trainer (``Model``, ``io``, ``metric``,
    ``amp``, ``callbacks``, the whole-step capture), ``autograd``,
    ``geometric``, ``incubate``, ``profiler``, ``device``, ``analysis``
    and ``utils.helpers`` — and chip_smoke — without pulling in JAX or
    the JAX package."""
    code = (
        "import paddle_tpu_torch as paddle\n"
        "assert callable(paddle.to_tensor) and callable(paddle.matmul)\n"
        "assert paddle.nn.Layer and paddle.optimizer.AdamW\n"
        "assert paddle.Model and paddle.io.DataLoader and "
        "paddle.metric.Accuracy and paddle.amp.auto_cast and "
        "paddle.callbacks.EarlyStopping and paddle.summary and "
        "paddle.flops\n"
        "import sys, chip_smoke, paddle_tpu_torch.serving, "
        "paddle_tpu_torch.models.gpt, paddle_tpu_torch.ops.op_registry, "
        "paddle_tpu_torch.convert, paddle_tpu_torch.models.llama, "
        "paddle_tpu_torch.ops.kernels.flash_attention, "
        "paddle_tpu_torch.ops.fused_ce, paddle_tpu_torch.optimizer, "
        "paddle_tpu_torch.jit, paddle_tpu_torch.nn.functional, "
        "paddle_tpu_torch.nn, paddle_tpu_torch.models.bert, "
        "paddle_tpu_torch.core.random, paddle_tpu_torch.models.ernie_moe, "
        "paddle_tpu_torch.ops.kernels.grouped_matmul, "
        "paddle_tpu_torch.optimizer.fused_step, paddle_tpu_torch.amp, "
        "paddle_tpu_torch.regularizer, paddle_tpu_torch.utils.clip_grad, "
        "paddle_tpu_torch.ops.kernels.multi_tensor, "
        "paddle_tpu_torch.serving_supervisor, paddle_tpu_torch.framework, "
        "paddle_tpu_torch.observability.flight, "
        "paddle_tpu_torch.observability.__main__, "
        "paddle_tpu_torch.utils.fault_injection, "
        "paddle_tpu_torch.utils.backoff, paddle_tpu_torch.jit.warmup, "
        "paddle_tpu_torch.serving_fleet, paddle_tpu_torch.inference, "
        "paddle_tpu_torch.jit.sot, paddle_tpu_torch.hapi, "
        "paddle_tpu_torch.observability.timeline, "
        "paddle_tpu_torch.autograd, paddle_tpu_torch.geometric, "
        "paddle_tpu_torch.incubate, paddle_tpu_torch.profiler, "
        "paddle_tpu_torch.device.cuda, paddle_tpu_torch.core.memory, "
        "paddle_tpu_torch.analysis.planner, "
        "paddle_tpu_torch.analysis.auditor, "
        "paddle_tpu_torch.analysis.__main__, "
        "paddle_tpu_torch.utils.helpers\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_checkpoint_write_and_read_load_no_jax(tmp_path):
    """A fresh interpreter writes and reads a checkpoint in the JAX
    package's format (f32 and bf16 tensors, the payload pickled under
    the JAX class path) and still has no JAX, ml_dtypes or JAX package
    loaded; the JAX package then reads the same file."""
    path = tmp_path / "ck"
    code = (
        "import sys, torch\n"
        "from paddle_tpu_torch.framework import checkpoint as c\n"
        "tree = {'w': torch.arange(6.).reshape(2, 3), "
        "'b': torch.tensor([1.5, -2.0]).bfloat16(), 'step': 4}\n"
        f"c.atomic_save(tree, {str(path)!r})\n"
        f"got = c.load_checkpoint({str(path)!r}, device='cpu')\n"
        "assert torch.equal(got['w'], tree['w'])\n"
        "assert got['b'].dtype == torch.bfloat16\n"
        "assert torch.equal(got['b'], tree['b']) and got['step'] == 4\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"
    assert b"paddle_tpu.framework.io" in path.read_bytes()
    from paddle_tpu.framework.checkpoint import load_checkpoint
    got = load_checkpoint(str(path), return_numpy=True)
    assert got["w"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert got["b"].astype("float32").tolist() == [1.5, -2.0]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    from paddle_tpu_torch.core.device import resolve_device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_entry_points_default_to_cuda(no_cuda):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (GenerationServer,
                                          LlamaDecodeEngine,
                                          PagedLlamaDecodeEngine)
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from paddle_tpu_torch.models.ernie_moe import (ErnieMoEConfig,
                                                   ErnieMoEForCausalLM)
    cfg = LlamaConfig.tiny(use_flash_attention=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertForMaskedLM(BertConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErnieMoEForCausalLM(ErnieMoEConfig.tiny())
    model = LlamaForCausalLM(cfg, device="cpu")
    assert next(model.parameters()).device == torch.device("cpu")
    for cls in (LlamaDecodeEngine, PagedLlamaDecodeEngine):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(model, max_slots=1, max_seq=32)
    eng = PagedLlamaDecodeEngine(model, max_slots=1, max_seq=32,
                                 device="cpu")
    srv = GenerationServer(eng)
    try:
        assert len(srv.generate([1, 2, 3], 3, timeout=60)) == 3
    finally:
        assert srv.shutdown(timeout=60)


def test_importing_the_top_level_loads_nothing_of_serving():
    """``import paddle_tpu_torch`` brings the eager core, the op surface,
    ``nn`` and ``optimizer``, and no serving module."""
    code = (
        "import sys, paddle_tpu_torch\n"
        "bad = sorted(m for m in sys.modules if 'serving' in m or "
        "m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'paddle_tpu_torch.nn.layer' in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_eager_core_defaults_to_cuda(no_cuda, monkeypatch):
    """The eager core's entry points make tensors and parameters on the
    card unless ``set_device("cpu")`` (or ``device="cpu"``) asks for
    the CPU; without CUDA they raise."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    monkeypatch.setattr(device, "_current", None)
    for make in (lambda: paddle.to_tensor([1.0]), lambda: paddle.ones([2]),
                 lambda: paddle.nn.LayerNorm(4),
                 lambda: GPTForCausalLM(GPTConfig.tiny())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    model = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    assert model.wte.weight.place == paddle.CPUPlace()
    paddle.set_device("cpu")
    assert paddle.to_tensor([1.0]).place == paddle.CPUPlace()


def test_flags_keep_the_jax_names_and_defaults(monkeypatch):
    import paddle_tpu.jit.warmup  # noqa: F401 — defines its flags
    import paddle_tpu_torch.jit.warmup  # noqa: F401 — defines its flags
    import paddle_tpu.jit.sot  # noqa: F401 — defines the capture flags
    from paddle_tpu.core import flags as jflags
    from paddle_tpu_torch.core import flags as tflags
    names = {"serving_block_size", "serving_num_blocks",
             "serving_prefill_chunk", "serving_prefix_cache",
             "serving_prefix_cache_blocks", "serving_shed_queue",
             "serving_admission_policy", "paged_attention_kernel",
             "fused_optimizer", "serving_spec_tokens",
             "serving_spec_draft_layers", "serving_supervisor_backoff",
             "serving_supervisor_stall_seconds", "backoff_full_jitter",
             "flight_recorder", "flight_recorder_capacity",
             "flight_dump_dir", "checkpoint_fsync",
             "serving_fleet_heartbeat_seconds",
             "serving_fleet_heartbeat_misses",
             "serving_fleet_restart_backoff", "serving_fleet_max_restarts",
             "serving_fleet_retry_after", "executable_cache_dir",
             "warmup_bundle", "executable_cache_gc_days", "sot_capture",
             "sot_capture_cache", "sot_cache_size", "sot_guard_budget",
             "check_nan_inf", "check_nan_inf_stride", "benchmark",
             "retain_grad_for_all_tensor", "metrics"}
    assert set(tflags._registry) == names
    for n in names:
        assert tflags._registry[n].default == jflags._registry[n].default
    monkeypatch.setenv("FLAGS_serving_block_size", "32")
    tflags.define_flag("serving_block_size", 16)
    try:
        assert tflags.flag_value("serving_block_size") == 32
        tflags.set_flags({"FLAGS_serving_block_size": "8"})
        assert tflags.get_flags("FLAGS_serving_block_size") == {
            "FLAGS_serving_block_size": 8}
    finally:
        tflags.set_flags({"serving_block_size": 16})
    with pytest.raises(ValueError, match="Unknown flag"):
        tflags.set_flags({"FLAGS_eager_fusion": 0})


def test_paged_attention_flag_off_raises_on_a_cuda_engine(monkeypatch):
    """On the card the kernel is the only attention path: the flag off
    raises instead of switching to the plain walk, and the walk runs
    only when asked for by name."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    monkeypatch.setattr(serving, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    set_flags({"FLAGS_paged_attention_kernel": False})
    try:
        with pytest.raises(ValueError, match="attention_impl='reference'"):
            serving.PagedLlamaDecodeEngine(model, max_slots=1, max_seq=32)
    finally:
        set_flags({"FLAGS_paged_attention_kernel": True})
    with pytest.raises(ValueError, match="attention_impl"):
        serving.LlamaDecodeEngine(model, max_slots=1, max_seq=32,
                                  device="cpu", attention_impl="flash")


def test_adaptive_policy_is_not_silently_dropped():
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.serving_supervisor import (
        AdaptiveAdmissionPolicy, StaticShedPolicy, default_policy)
    assert isinstance(default_policy(), StaticShedPolicy)
    set_flags({"serving_admission_policy": "adaptive"})
    try:
        assert isinstance(default_policy(), AdaptiveAdmissionPolicy)
    finally:
        set_flags({"serving_admission_policy": "static"})


def test_kernel_build_is_lazy_and_names_sm90a(monkeypatch, tmp_path):
    """Importing the kernel modules builds nothing; the build targets
    sm_90a into a directory the environment can move, keyed by a hash
    of the source; without nvcc, loading a kernel raises."""
    from paddle_tpu_torch.ops.kernels import build
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert {"-O3", "-shared", "-Xcompiler", "-fPIC"} <= set(
        build.NVCC_FLAGS)
    # the first flash design builds as four libraries, one per (dtype,
    # head dim), and the TMA design as a fifth; the two paged-attention
    # designs as two more, the optimizer kernels as one, so that nvcc
    # compiles them in parallel
    assert [p.name for p in build.sources()] == [
        "flash_attention_bf16_d128.cu", "flash_attention_bf16_d64.cu",
        "flash_attention_f32_d128.cu", "flash_attention_f32_d64.cu",
        "flash_attention_tma.cu", "grouped_matmul.cu",
        "multi_tensor_optimizer.cu", "paged_attention.cu",
        "paged_attention_split.cu"]
    monkeypatch.setenv(build.BUILD_DIR_ENV, str(tmp_path / "k"))
    assert build.build_dir() == tmp_path / "k"
    lib = build._library(build.sources()[-1])
    assert lib.parent == tmp_path / "k"
    assert lib.name.startswith("libpaged_attention_")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    for name in ("paged_attention", "paged_attention_split",
                 "flash_attention_bf16_d64", "flash_attention_tma",
                 "grouped_matmul", "multi_tensor_optimizer"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load(name)
    assert not (tmp_path / "k").exists()


VISION_MODULES = ("nn/functional/conv.py", "nn/functional/pooling.py",
                  "vision/__init__.py", "vision/image.py",
                  "vision/transforms.py", "vision/datasets.py",
                  "vision/models/__init__.py", "vision/models/_utils.py",
                  "vision/models/resnet.py")


def test_port_covers_the_vision_modules():
    have = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert set(VISION_MODULES) <= have, sorted(set(VISION_MODULES) - have)


def test_importing_the_vision_slice_loads_no_jax():
    """The vision slice (conv, pooling and norm functionals and layers,
    the ResNet family, transforms and datasets) imports without JAX, and
    ``resnet50(data_format="NHWC")`` builds (on the CPU, by name)."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch as paddle\n"
        "import paddle_tpu_torch.vision.models.resnet, "
        "paddle_tpu_torch.vision.transforms, "
        "paddle_tpu_torch.vision.datasets, paddle_tpu_torch.vision.image, "
        "paddle_tpu_torch.nn.functional.conv, "
        "paddle_tpu_torch.nn.functional.pooling\n"
        "paddle.set_device('cpu')\n"
        "m = paddle.vision.models.resnet50(data_format='NHWC')\n"
        "assert sum(p.size for p in m.parameters()) == 25557032\n"
        "assert paddle.nn.Conv2D and paddle.nn.BatchNorm2D and "
        "paddle.nn.MaxPool2D and paddle.nn.Flatten\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


VISION_ZOO_MODULES = (
    "nn/functional/vision.py", "nn/functional/extension.py",
    "nn/layers_common.py", "vision/ops.py", "vision/detection_ops.py",
    "vision/models/lenet.py", "vision/models/alexnet.py",
    "vision/models/vgg.py", "vision/models/squeezenet.py",
    "vision/models/mobilenet.py", "vision/models/mobilenetv3.py",
    "vision/models/densenet.py", "vision/models/shufflenetv2.py",
    "vision/models/googlenet.py", "vision/models/inceptionv3.py")


def test_port_covers_the_vision_zoo_modules():
    have = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert set(VISION_ZOO_MODULES) <= have, sorted(
        set(VISION_ZOO_MODULES) - have)


def test_importing_the_vision_zoo_loads_no_jax():
    """The model zoo, ``vision.ops`` and the vision and extension
    functionals import without JAX, and MobileNetV2 at its published
    widths builds (on the CPU, by name) with the JAX model's parameter
    count."""
    mods = ", ".join("paddle_tpu_torch." + m[:-3].replace("/", ".")
                     for m in VISION_ZOO_MODULES)
    code = (
        "import sys\n"
        "import paddle_tpu_torch as paddle\n"
        f"import {mods}\n"
        "paddle.set_device('cpu')\n"
        "m = paddle.vision.models.mobilenet_v2(scale=1.0, num_classes=1000)\n"
        "assert sum(p.size for p in m.parameters()) == 3504872\n"
        "assert paddle.vision.ops.roi_align and paddle.nn.ChannelShuffle "
        "and paddle.nn.functional.grid_sample\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
