"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The port runs on an NVIDIA Hopper card (H100) and keeps the JAX
package's module names, so each module here has a counterpart of the
same name in ``paddle_tpu``.

Serving (paged-KV Llama):

- ``models.llama`` — ``LlamaConfig`` and the ``LlamaForCausalLM``
  module tree (same parameter names as the JAX model);
- ``convert`` — carries JAX weights (and optimizer state) across as
  numpy;
- ``serving_cache`` — the paged KV block pool, its radix prefix tree
  and the ``paged_attention`` seam;
- ``serving`` — the dense and paged decode engines and the
  ``GenerationServer``;
- ``ops.kernels.paged_attention`` — the hand-written Hopper
  paged-attention kernel and its plain PyTorch walk;
- ``serving_supervisor`` — the admission policies, the supervised
  decode loop (crash and stall recovery) and canary ``rollout``;
- ``framework`` — ``save`` / ``load`` and the crash-safe checkpoints
  (``CheckpointManager``) in the JAX package's file format;
- ``observability`` — metrics, the flight recorder with its dumps and
  crash hooks, and their CLI; ``utils.fault_injection`` and
  ``utils.backoff``.

Training (Llama with AdamW):

- ``ops.kernels.flash_attention`` — the hand-written Hopper flash
  attention forward, dQ and dK/dV kernels, their plain versions and
  the ``FlashAttention`` autograd function;
- ``nn.functional`` — the paddle attention entries;
- ``ops.fused_ce`` — the chunked fused cross-entropy;
- ``optimizer`` — ``Adam`` and ``AdamW``;
- ``jit`` — ``TrainStep``;
- ``ops.kernels.build`` — the ``nvcc`` build of every kernel source.

BERT-base MLM training (dropout inside and around attention):

- ``models.bert`` — ``BertConfig`` and ``BertForMaskedLM`` (same
  parameter names as the JAX model);
- ``nn`` — ``TransformerEncoder``/``TransformerEncoderLayer``/
  ``MultiHeadAttention``, ``LayerNorm``, ``Dropout``,
  ``CrossEntropyLoss``; ``nn.functional`` — ``dropout`` (the JAX hash
  mask), ``gelu``, ``tanh``, ``layer_norm``, ``cross_entropy`` and the
  packed-varlen entry ``flash_attn_varlen_qkvpacked``;
- ``core.random`` — the port's generators, whose key streams live on
  the device: the keys of the kernels' Philox dropout and the hash
  dropout's seed (``derive_seed``), drawn without a host read;
- ``ops.kernels.flash_attention`` again — attention dropout (the
  Philox keep mask) and segment (varlen) masking inside the same
  kernels.

ERNIE-MoE training and the grouped-matmul op:

- ``models.ernie_moe`` — ``ErnieMoEConfig`` and ``ErnieMoEForCausalLM``
  (same parameter names as the JAX model); ``models.gpt`` —
  ``GPTConfig`` and ``GPTAttention`` (causal flash attention);
- ``incubate.moe`` — ``MoELayer`` and its naive, Switch and GShard
  gates; ``incubate.moe_dispatch`` — the capacity dispatch tables and
  the index forward;
- ``ops.kernels.grouped_matmul`` — the ``grouped_matmul`` op, the
  hand-written Hopper grouped-matmul kernels (forward and dlhs; drhs),
  their plain versions and the ``GroupedMatmul`` autograd function;
- ``convert`` again — the expert stacks and gate weights copied as
  they are.

The paddle-API eager core and GPT on it:

- ``core.dtype``, ``core.tensor`` (``Tensor``, ``Parameter``,
  ``to_tensor``), ``core.autograd`` (grad modes, ``apply_op``,
  ``backward``, ``grad``), ``core.device`` (``set_device`` and the
  places) and ``core.random`` (``seed``);
- ``ops`` — the creation, math, manipulation and linear-algebra ops
  with the Tensor methods and operators, the in-place ``op_`` forms,
  and the op table (``ops.op_registry`` over ``ops/ops.yaml``);
- ``nn`` — ``Layer`` (a ``torch.nn.Module`` with paddle's methods),
  the containers, ``Linear``, ``Embedding``, ``Dropout``,
  ``LayerNorm``, ``RMSNorm``, ``CrossEntropyLoss``, ``initializer``
  and the functional entries on Tensors;
- ``models.gpt`` — ``GPTForCausalLM`` (its attention through the flash
  kernels).

The high-level trainer:

- ``amp`` — ``auto_cast`` / ``decorate`` (the op-name cast hook of
  ``core.autograd.apply_op``) and ``GradScaler``;
- ``io`` — datasets, samplers and the ``DataLoader`` (worker processes,
  the ``/dev/shm`` transport, batches on the loader's device);
- ``metric`` and ``callbacks`` (``hapi.callbacks``);
- ``jit.sot`` — ``CapturedStep``: a train or eval step as one CUDA graph
  per signature;
- ``hapi`` — ``Model`` (``prepare`` / ``fit`` / ``evaluate`` /
  ``predict`` / ``save`` / ``load``, its steps through
  ``CapturedStep``), ``summary`` and ``flops``;
- ``observability.timeline`` — ``StepTimer``;
- ``vision`` — the ResNet family (``vision.models``), the numpy
  transforms and the synthetic datasets.

``import paddle_tpu_torch as paddle`` gives the names of the JAX
package's top level that are ported: the dtypes, ``Tensor``,
``Parameter``, ``to_tensor``, the grad modes and ``grad``, the flags,
``seed``, the devices, the op surface, ``nn``, ``optimizer``, ``amp``,
``io``, ``metric``, ``callbacks``, ``vision``, ``Model``, ``summary``
and ``flops``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (the eager core: ``set_device("cpu")``); without CUDA
and without that it raises. Importing this package imports no JAX and
nothing of serving: ``paddle_tpu_torch.save`` / ``load`` bind
``framework.io``'s on first use.
"""

from .core.dtype import (  # noqa: F401
    bool_, bool_ as bool8, uint8, int8, int16, int32, int64, float16,
    bfloat16, float32, float64, complex64, complex128, get_default_dtype,
    set_default_dtype,
)
from .core import dtype as dtype_module  # noqa: F401
from .core.tensor import Tensor, Parameter, to_tensor  # noqa: F401
from .core.autograd import (  # noqa: F401
    no_grad, enable_grad, is_grad_enabled, set_grad_enabled, grad,
)
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.random import seed, get_rng_state, set_rng_state  # noqa: F401
from .core.device import (  # noqa: F401
    set_device, get_device, device_count, is_compiled_with_cuda,
    is_compiled_with_tpu, CPUPlace, CUDAPlace, TPUPlace, Place,
)

from .ops import *  # noqa: F401,F403,E402
from .ops import cast, increment  # noqa: F401,E402

from . import nn  # noqa: F401,E402
from . import optimizer  # noqa: F401,E402
from . import amp  # noqa: F401,E402
from . import io  # noqa: F401,E402
from . import metric  # noqa: F401,E402
from . import callbacks  # noqa: F401,E402
from . import jit  # noqa: F401,E402
from . import static  # noqa: F401,E402
from .hapi import Model, summary, flops  # noqa: F401,E402


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A new Parameter (zeros for a bias, XavierNormal otherwise)."""
    from .core.device import current_device
    from .core.dtype import convert_dtype
    from .nn import initializer as _init
    init = default_initializer or (_init.Constant(0.0) if is_bias
                                   else _init.XavierNormal())
    return Parameter(init(tuple(shape), convert_dtype(dtype),
                          current_device()), name=name)


def __getattr__(name):
    if name in ("save", "load"):
        from .framework import io
        return getattr(io, name)
    if name == "vision":
        # imported on first use: a process that serves an exported
        # program imports no model class (jit.load -> TranslatedLayer)
        import importlib
        return importlib.import_module(".vision", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# paddle.bool: assigned last so the module body above keeps the builtin
bool = bool_  # noqa: A001
