"""Functional ops of the port (the paddle ``nn.functional`` names);
each takes Tensors or torch tensors and returns the same kind."""
from .activation import *  # noqa: F401,F403
from .attention import (flash_attention,  # noqa: F401
                        flash_attn_varlen_qkvpacked,
                        scaled_dot_product_attention, sdpa_reference)
from .common import (alpha_dropout, channel_shuffle,  # noqa: F401
                     dropout, dropout2d, dropout3d, embedding, fold,
                     interpolate, label_smooth, linear, one_hot,
                     pixel_shuffle, pixel_unshuffle, upsample, zeropad2d)
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   layer_norm, local_response_norm, rms_norm)
from .pooling import *  # noqa: F401,F403
