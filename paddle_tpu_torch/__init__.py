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

The autograd core's rest and the incubating modules:

- ``autograd`` — ``PyLayer``, ``saved_tensors_hooks``, ``jacobian`` /
  ``hessian`` / ``vjp`` / ``jvp``; ``core.autograd``'s per-op NaN/Inf
  scan (``FLAGS_check_nan_inf``);
- ``incubate`` — the fused transformer layers, ASP, ``LookAhead``,
  ``ModelAverage`` and the long tail; ``geometric`` — segment
  reductions, message passing, reindexing and neighbour sampling.

``import paddle_tpu_torch as paddle`` gives the names of the JAX
package's top level that are ported: the dtypes, ``Tensor``,
``Parameter``, ``to_tensor``, the grad modes and ``grad``, the flags,
``seed``, the devices, the op surface (``ops.extra_math`` included),
``nn``, ``autograd``, ``optimizer``, ``amp``, ``io``, ``metric``,
``callbacks``, ``linalg``, ``vision``, ``Model``, ``summary``, ``flops``
and the JAX
top-level tail (``finfo``, ``iinfo``, the static-mode switches, the
places, ``rank``, ``shape``, ``binomial`` ...). What is left is pinned
by ``tests/test_torch_surface.py``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (the eager core: ``set_device("cpu")``); without CUDA
and without that it raises. Importing this package imports no JAX and
nothing of serving: ``paddle_tpu_torch.save`` / ``load`` bind
``framework.io``'s on first use.

What a step keeps inside its graph, and how a user sees it:
``profiler`` (``paddle.profiler``: the native host tracer, the card's
CUPTI plane, one merged chrome trace), ``device`` (``paddle.device``:
streams, events, the allocator's memory counters), ``analysis``
(lint, the host-sync auditor, the capture planner; ``python -m
paddle_tpu_torch.analysis``) and ``utils.helpers`` (``run_check``).
"""

import torch  # noqa: E402

__version__ = "0.1.0"

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
from . import autograd  # noqa: F401,E402
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


from . import linalg  # noqa: F401,E402
from .core.autograd import apply_op  # noqa: F401,E402
from .core.dtype import convert_dtype  # noqa: F401,E402
from .nn import ParamAttr  # noqa: F401,E402

# the subpackages the JAX package imports at its top level and the port
# has, imported on first use: a process that serves an exported program
# imports no model class (jit.load -> TranslatedLayer)
_LAZY = ("vision", "models", "incubate", "inference", "framework",
         "regularizer", "utils", "observability", "geometric",
         "profiler", "device", "analysis")


def __getattr__(name):
    if name in ("save", "load"):
        from .framework import io
        return getattr(io, name)
    if name in _LAZY:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# -- the JAX package's top-level tail (paddle_tpu/__init__.py) ---------------

def disable_static(place=None):
    """Back to eager mode, which is the port's only mode."""


def enable_static():
    """Static-graph mode (``Program`` / ``Executor``) is ROADMAP item 15:
    it raises until then."""
    raise NotImplementedError(
        "paddle_tpu_torch has no static-graph mode yet (ROADMAP queue 1, "
        "item 15); jit.to_static captures programs in eager code")


def in_dynamic_mode():
    return True


def iinfo(dtype):
    """Integer type info (``bits``, ``min``, ``max``, ``dtype``)."""
    return torch.iinfo(convert_dtype(dtype))


def finfo(dtype):
    """Float type info (``bits``, ``eps``, ``min``, ``max``, ``tiny``,
    ``resolution``, ``dtype``)."""
    return torch.finfo(convert_dtype(dtype))


dtype = torch.dtype
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2


class CUDAPinnedPlace(Place):
    def __init__(self):
        super().__init__("gpu_pinned", 0)


class LazyGuard:
    """Deferred parameter creation: a no-op context, parameters are made
    where they are declared."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def rank(x):
    """The number of dimensions, a 0-D int64 Tensor."""
    from .core.tensor import as_torch
    t = as_torch(x)
    return Tensor(torch.tensor(t.dim(), dtype=torch.int64, device=t.device))


def shape(x):
    """The shape, an int64 Tensor."""
    from .core.tensor import as_torch
    t = as_torch(x)
    return Tensor(torch.tensor(list(t.shape), dtype=torch.int64,
                               device=t.device))


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Print options of tensors (and of numpy, which the Tensor repr
    uses)."""
    import numpy as np
    kw = {k: v for k, v in (("precision", precision),
                            ("threshold", threshold),
                            ("edgeitems", edgeitems),
                            ("linewidth", linewidth)) if v is not None}
    torch.set_printoptions(sci_mode=sci_mode, **kw)
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


def is_compiled_with_cinn():
    return False


def is_compiled_with_rocm():
    return False


def is_compiled_with_xpu():
    return False


def disable_signal_handler():
    return None


def check_shape(x):
    return None


def batch(reader, batch_size, drop_last=False):
    """The legacy reader decorator: lists of ``batch_size`` items."""
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batched


def get_cuda_rng_state():
    """The port's generator state (one stream serves every device)."""
    return get_rng_state()


def set_cuda_rng_state(state):
    return set_rng_state(state)


def binomial(count, prob, name=None):
    """Binomial draws with per-element counts and probabilities, int64,
    from a generator seeded by a host draw of the port's generator."""
    from .core import random as _random

    def f(n, p):
        g = _random.generator_for(n.device)
        return torch.binomial(n.float(), p.float(), generator=g).long()
    return apply_op(f, count, prob, op_name="binomial")


def addmm_(input, x, y, beta=1.0, alpha=1.0, name=None):
    out = addmm(input, x, y, beta=beta, alpha=alpha)  # noqa: F405
    input._assign(out._t)
    return input


def where_(condition, x, y, name=None):
    """``where(condition, x, y)`` written into x."""
    out = where(condition, x, y)  # noqa: F405
    x._assign(out._t)
    return x


def tolist(x):
    return x.tolist()


def _toplevel_inplace(name):
    def f(x, *args, **kwargs):
        return getattr(x, name)(*args, **kwargs)
    f.__name__ = name
    return f


# the random in-place fills, at the top level as in the JAX package
normal_ = _toplevel_inplace("normal_")
log_normal_ = _toplevel_inplace("log_normal_")
bernoulli_ = _toplevel_inplace("bernoulli_")
cauchy_ = _toplevel_inplace("cauchy_")
geometric_ = _toplevel_inplace("geometric_")


# paddle.bool: assigned last so the module body above keeps the builtin
bool = bool_  # noqa: A001
