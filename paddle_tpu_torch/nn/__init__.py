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
from .transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerEncoder,
    TransformerEncoderLayer, TransformerDecoder, TransformerDecoderLayer,
)
from .rnn import (  # noqa: F401
    SimpleRNN, LSTM, GRU, SimpleRNNCell, LSTMCell, GRUCell, RNN, BiRNN,
    RNNCellBase,
)
from .layers_extra import (  # noqa: F401
    PairwiseDistance, Softmax2D, Unflatten, FeatureAlphaDropout,
    ZeroPad1D, ZeroPad3D, MaxUnPool1D, MaxUnPool2D, MaxUnPool3D,
    LPPool1D, LPPool2D, FractionalMaxPool2D, FractionalMaxPool3D,
    RNNTLoss, HSigmoidLoss, TripletMarginWithDistanceLoss,
    AdaptiveLogSoftmaxWithLoss,
)
from .decode import Decoder, BeamSearchDecoder, dynamic_decode  # noqa: F401
from . import rnn, decode, layers_extra  # noqa: F401
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from ..utils.clip_grad import (ClipGradByGlobalNorm,  # noqa: F401
                               ClipGradByNorm, ClipGradByValue)
