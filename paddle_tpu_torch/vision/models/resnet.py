"""The ResNet family of the port.

The port of ``paddle_tpu/vision/models/resnet.py`` (ref:
python/paddle/vision/models/resnet.py): ``BasicBlock``,
``BottleneckBlock``, ``ResNet``, ``resnet18`` .. ``resnet152``, the wide
and ResNeXt variants, with the JAX package's structure and names, so
state dicts correspond (``convert.resnet_from_jax`` carries them over).
``data_format="NHWC"`` builds every conv, batch norm and pool for
``[N, H, W, C]`` activations. ``pretrained=True`` loads a local weights
file only (``_utils.load_pretrained``).
"""
from __future__ import annotations

from ... import nn

__all__ = [
    "ResNet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
    "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
    "resnext152_32x4d", "resnext152_64x4d",
]


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        df = data_format
        self.conv1 = nn.Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                               bias_attr=False, data_format=df)
        self.bn1 = norm_layer(planes, data_format=df)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1,
                               bias_attr=False, data_format=df)
        self.bn2 = norm_layer(planes, data_format=df)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        df = data_format
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False,
                               data_format=df)
        self.bn1 = norm_layer(width, data_format=df)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation,
                               stride=stride, groups=groups,
                               dilation=dilation, bias_attr=False,
                               data_format=df)
        self.bn2 = norm_layer(width, data_format=df)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, data_format=df)
        self.bn3 = norm_layer(planes * self.expansion, data_format=df)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """ref: vision/models/resnet.py ResNet."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW"):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = nn.BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        # NHWC: activations stay [N, H, W, C]; cuDNN takes each as a
        # channels-last view and the batch norms reduce over the leading
        # axes with C contiguous
        self.data_format = data_format

        df = data_format
        self.conv1 = nn.Conv2D(3, self.inplanes, kernel_size=7, stride=2,
                               padding=3, bias_attr=False, data_format=df)
        self.bn1 = self._norm_layer(self.inplanes, data_format=df)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1,
                                    data_format=df)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1), data_format=df)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, blocks, stride=1):
        norm_layer = self._norm_layer
        df = self.data_format
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, data_format=df),
                norm_layer(planes * block.expansion, data_format=df))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, norm_layer=norm_layer,
                        data_format=df)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, data_format=df))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.fc(x)
        return x


# published weight artifacts (ref: vision/models/resnet.py model_urls):
# the file names and checksums a local weights file is found and
# checked by; nothing is downloaded
model_urls = {
    "resnet18": (
        "https://paddle-hapi.bj.bcebos.com/models/resnet18.pdparams",
        "cf548f46534aa3560945be4b95cd11c4"),
    "resnet34": (
        "https://paddle-hapi.bj.bcebos.com/models/resnet34.pdparams",
        "8d2275cf8706028345f78ac0e1d31969"),
    "resnet50": (
        "https://paddle-hapi.bj.bcebos.com/models/resnet50.pdparams",
        "ca6f485ee1ab0492d38f323885b0ad80"),
    "resnet101": (
        "https://paddle-hapi.bj.bcebos.com/models/resnet101.pdparams",
        "02f35f034ca3858e1e54d4036443c92d"),
    "resnet152": (
        "https://paddle-hapi.bj.bcebos.com/models/resnet152.pdparams",
        "7ad16a2f1e7333859ff986138630fd7a"),
    "resnext50_32x4d": (
        "https://paddle-hapi.bj.bcebos.com/models/resnext50_32x4d.pdparams",
        "dc47483169be7d6f018fcbb7baf8775d"),
    "resnext50_64x4d": (
        "https://paddle-hapi.bj.bcebos.com/models/resnext50_64x4d.pdparams",
        "063d4b483e12b06388529450ad7576db"),
    "resnext101_32x4d": (
        "https://paddle-hapi.bj.bcebos.com/models/resnext101_32x4d.pdparams",
        "967b090039f9de2c8d06fe994fb9095f"),
    "resnext101_64x4d": (
        "https://paddle-hapi.bj.bcebos.com/models/resnext101_64x4d.pdparams",
        "98e04e7ca616a066699230d769d03008"),
    "resnext152_32x4d": (
        "https://paddle-hapi.bj.bcebos.com/models/resnext152_32x4d.pdparams",
        "18ff0beee21f2efc99c4b31786107121"),
    "resnext152_64x4d": (
        "https://paddle-hapi.bj.bcebos.com/models/resnext152_64x4d.pdparams",
        "77c4af00ca42c405fa7f841841959379"),
    "wide_resnet50_2": (
        "https://paddle-hapi.bj.bcebos.com/models/wide_resnet50_2.pdparams",
        "0282f804d73debdab289bd9fea3fa6dc"),
    "wide_resnet101_2": (
        "https://paddle-hapi.bj.bcebos.com/models/wide_resnet101_2.pdparams",
        "d4360a2d23657f059216f5d5a1a9ac93"),
}


def load_pretrained(model, arch, urls=None):
    """Install published weights (``_utils.load_pretrained``; this file's
    table by default)."""
    from ._utils import load_pretrained as _lp
    return _lp(model, arch, model_urls if urls is None else urls)


def _resnet(block, depth, pretrained=False, arch=None, **kwargs):
    model = ResNet(block, depth, **kwargs)
    if pretrained:
        load_pretrained(model, arch or f"resnet{depth}")
    return model


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, pretrained,
                   arch="wide_resnet50_2", **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 101, pretrained,
                   arch="wide_resnet101_2", **kwargs)


def _resnext(depth, groups, pretrained, **kwargs):
    kwargs["groups"] = groups
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, depth, pretrained,
                   arch=f"resnext{depth}_{groups}x4d", **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnext(50, 32, pretrained, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnext(50, 64, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnext(101, 32, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnext(101, 64, pretrained, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnext(152, 32, pretrained, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnext(152, 64, pretrained, **kwargs)
