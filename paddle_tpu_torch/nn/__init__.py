"""Neural-network building blocks of the port (the paddle ``nn`` names
the ported paths use; ``Linear`` and ``Embedding`` are torch's)."""
from .layers_common import Dropout  # noqa: F401
from .layers_conv_norm import LayerNorm  # noqa: F401
from .layers_loss import CrossEntropyLoss  # noqa: F401
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
from ..utils.clip_grad import (ClipGradByGlobalNorm,  # noqa: F401
                               ClipGradByNorm, ClipGradByValue)
