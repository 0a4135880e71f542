"""The port's vision models (``paddle_tpu/vision/models``): the ResNet
family, LeNet, VGG, MobileNet V1/V2/V3, AlexNet, SqueezeNet, DenseNet,
ShuffleNetV2, GoogLeNet and Inception v3, with the JAX package's
structure and parameter names (``convert.vision_from_jax`` carries a
JAX model's ``state_dict()`` across). ``pretrained=True`` loads a local
weights file only (``_utils.load_pretrained``)."""
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, wide_resnet50_2, wide_resnet101_2,
    resnext50_32x4d, resnext50_64x4d, resnext101_32x4d, resnext101_64x4d,
    resnext152_32x4d, resnext152_64x4d,
)
from .lenet import LeNet  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenet import (  # noqa: F401
    MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2,
)
from .mobilenetv3 import (  # noqa: F401
    MobileNetV3Small, MobileNetV3Large, mobilenet_v3_small,
    mobilenet_v3_large,
)
from .alexnet import AlexNet, alexnet  # noqa: F401
from .squeezenet import (  # noqa: F401
    SqueezeNet, squeezenet1_0, squeezenet1_1,
)
from .densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201,
    densenet264,
)
from .shufflenetv2 import (  # noqa: F401
    ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_33,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, shufflenet_v2_swish,
)
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401

# the JAX package's zoo surface, name for name
__all__ = [
    "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
    "resnet152", "resnext50_32x4d", "resnext50_64x4d",
    "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
    "resnext152_64x4d", "wide_resnet50_2", "wide_resnet101_2",
    "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "MobileNetV1", "mobilenet_v1", "MobileNetV2", "mobilenet_v2",
    "MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
    "mobilenet_v3_large", "LeNet",
    "DenseNet", "densenet121", "densenet161", "densenet169",
    "densenet201", "densenet264",
    "AlexNet", "alexnet", "InceptionV3", "inception_v3",
    "SqueezeNet", "squeezenet1_0", "squeezenet1_1",
    "GoogLeNet", "googlenet",
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "shufflenet_v2_swish",
]
