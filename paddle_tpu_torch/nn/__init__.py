"""Neural-network building blocks of the port (``paddle.nn``): the
:class:`Layer` base, its containers, the layers the ported models use
and the initializers."""
from .layer import Layer, ParamAttr  # noqa: F401
from .container import (  # noqa: F401
    Sequential, LayerList, ParameterList, LayerDict, ParameterDict,
)
from .layers_common import *  # noqa: F401,F403
from .layers_conv_norm import *  # noqa: F401,F403
from .layers_activation import *  # noqa: F401,F403
from .layers_loss import *  # noqa: F401,F403
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from ..utils.clip_grad import (ClipGradByGlobalNorm,  # noqa: F401
                               ClipGradByNorm, ClipGradByValue)
