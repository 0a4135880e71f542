"""Functional ops of the port (the paddle ``nn.functional`` names);
each takes Tensors or torch tensors and returns the same kind."""
from .activation import *  # noqa: F401,F403
from .attention import (flash_attention,  # noqa: F401
                        flash_attn_qkvpacked, flash_attn_varlen_qkvpacked,
                        flashmask_attention, scaled_dot_product_attention,
                        sdpa_reference)
from .common import (alpha_dropout, bilinear,  # noqa: F401
                     channel_shuffle, cosine_similarity, dropout,
                     dropout2d, dropout3d, embedding,
                     feature_alpha_dropout, fold, interpolate,
                     label_smooth, linear, normalize, one_hot,
                     pairwise_distance, pixel_shuffle, pixel_unshuffle,
                     upsample, zeropad2d)
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   layer_norm, local_response_norm, rms_norm)
from .pooling import *  # noqa: F401,F403
from .vision import *  # noqa: F401,F403
from .extension import *  # noqa: F401,F403
# pad and unfold live with the tensor manipulation ops, as in the JAX
# package, and are exported here as well
from ...ops.manipulation import pad, unfold  # noqa: F401,E402
# as the JAX package's functional namespace shows it
from ...core.autograd import is_grad_enabled  # noqa: F401,E402
