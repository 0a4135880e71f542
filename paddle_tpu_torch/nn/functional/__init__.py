"""Functional ops of the port (the paddle ``nn.functional`` names);
each takes Tensors or torch tensors and returns the same kind."""
from .activation import *  # noqa: F401,F403
from .attention import (flash_attention,  # noqa: F401
                        flash_attn_varlen_qkvpacked,
                        scaled_dot_product_attention, sdpa_reference)
from .common import (dropout, embedding, label_smooth,  # noqa: F401
                     linear, one_hot)
from .loss import *  # noqa: F401,F403
from .norm import layer_norm, rms_norm  # noqa: F401
