"""``paddle.jit`` of the port: ``to_static`` (SOT segments replayed as
CUDA graphs, or with ``full_graph=True`` one graph a signature),
``save`` / ``load`` / ``TranslatedLayer`` (the inference artifact,
served without the model's class through its ``torch.export``
program), ``TrainStep`` and ``CapturedStep`` (a train step as one CUDA
graph per signature, behind ``hapi.Model``), and ``capture_jit`` (a
whole-step function — the serving engines' bodies — as one CUDA graph
per signature, its graphs grouped by a ``CaptureGroup``)."""
from .api import to_static, functionalize, TrainStep, save, load, not_to_static  # noqa: F401
from .api import ignore_module, TranslatedLayer, enable_to_static  # noqa: F401
from .api import set_code_level, set_verbosity, InputSpec  # noqa: F401
from .api import StaticFunction  # noqa: F401
from .sot import sot_compile, SOTFunction, BucketPolicy  # noqa: F401
from .sot import capture, CapturedStep  # noqa: F401
from .sot import capture_jit, CapturedProgram, CaptureGroup  # noqa: F401
from . import warmup  # noqa: F401
