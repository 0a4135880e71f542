"""Incubating modules of the port: the MoE layer and its dispatch
(``moe``, ``moe_dispatch``), the fused layers and functionals
(``incubate.nn``), 2:4 structured sparsity (``asp``), the
``inference`` namespace and the long tail of ``extras``
(``LookAhead``, ``ModelAverage``, the fused masked softmax,
``identity_loss`` and the ``graph_*`` / ``segment_*`` names over
``geometric``)."""
from . import asp  # noqa: F401
from . import inference  # noqa: F401
from . import moe  # noqa: F401
from . import nn  # noqa: F401
from .extras import (  # noqa: F401
    LookAhead, ModelAverage, graph_khop_sampler, graph_reindex,
    graph_sample_neighbors, graph_send_recv, identity_loss, segment_max,
    segment_mean, segment_min, segment_sum, softmax_mask_fuse,
    softmax_mask_fuse_upper_triangle)
