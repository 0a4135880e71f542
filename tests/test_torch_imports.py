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
            "ops/kernels/multi_tensor.py"}
    have = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert want <= have, sorted(want - have)
    for src in ("paged_attention.cu", "flash_attention.cuh",
                "flash_attention_bf16_d64.cu", "flash_attention_bf16_d128.cu",
                "flash_attention_f32_d64.cu", "flash_attention_f32_d128.cu",
                "grouped_matmul.cu", "multi_tensor_optimizer.cu"):
        assert (PKG / "ops/kernels/csrc" / src).is_file()


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter with only the repo on its path imports the
    serving, Llama, BERT and ERNIE-MoE training stacks, the grouped
    matmul op and the optimizer plane (and chip_smoke) without pulling
    in JAX or the JAX package."""
    code = (
        "import sys, chip_smoke, paddle_tpu_torch.serving, "
        "paddle_tpu_torch.convert, paddle_tpu_torch.models.llama, "
        "paddle_tpu_torch.ops.kernels.flash_attention, "
        "paddle_tpu_torch.ops.fused_ce, paddle_tpu_torch.optimizer, "
        "paddle_tpu_torch.jit, paddle_tpu_torch.nn.functional, "
        "paddle_tpu_torch.nn, paddle_tpu_torch.models.bert, "
        "paddle_tpu_torch.core.random, paddle_tpu_torch.models.ernie_moe, "
        "paddle_tpu_torch.ops.kernels.grouped_matmul, "
        "paddle_tpu_torch.optimizer.fused_step, paddle_tpu_torch.amp, "
        "paddle_tpu_torch.regularizer, paddle_tpu_torch.utils.clip_grad, "
        "paddle_tpu_torch.ops.kernels.multi_tensor\n"
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


def test_flags_keep_the_jax_names_and_defaults(monkeypatch):
    from paddle_tpu.core import flags as jflags
    from paddle_tpu_torch.core import flags as tflags
    names = {"serving_block_size", "serving_num_blocks",
             "serving_prefill_chunk", "serving_prefix_cache",
             "serving_prefix_cache_blocks", "serving_shed_queue",
             "serving_admission_policy", "paged_attention_kernel",
             "fused_optimizer", "serving_spec_tokens",
             "serving_spec_draft_layers"}
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
        tflags.set_flags({"FLAGS_metrics": 0})


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
