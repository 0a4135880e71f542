"""SqueezeNet 1.0 / 1.1 of the port
(``paddle_tpu/vision/models/squeezenet.py``): Fire modules, ceil-free
``MaxPool2D(3, 2)`` on odd sizes, a 1×1 conv classifier."""
from __future__ import annotations

from ... import concat, nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(nn.Layer):
    def __init__(self, in_ch, squeeze, expand1x1, expand3x3):
        super().__init__()
        self.squeeze = nn.Conv2D(in_ch, squeeze, 1)
        self.relu = nn.ReLU()
        self.expand1x1 = nn.Conv2D(squeeze, expand1x1, 1)
        self.expand3x3 = nn.Conv2D(squeeze, expand3x3, 3, padding=1)

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return concat([self.relu(self.expand1x1(x)),
                       self.relu(self.expand3x3(x))], axis=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version: str = "1.0", num_classes: int = 1000,
                 with_pool: bool = True):
        super().__init__()
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                Fire(96, 16, 64, 64), Fire(128, 16, 64, 64),
                Fire(128, 32, 128, 128),
                nn.MaxPool2D(3, stride=2),
                Fire(256, 32, 128, 128), Fire(256, 48, 192, 192),
                Fire(384, 48, 192, 192), Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, stride=2),
                Fire(512, 64, 256, 256),
            )
        elif version == "1.1":
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                Fire(64, 16, 64, 64), Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, stride=2),
                Fire(128, 32, 128, 128), Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, stride=2),
                Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
                Fire(384, 64, 256, 256), Fire(512, 64, 256, 256),
            )
        else:
            raise ValueError(f"unsupported SqueezeNet version {version!r}")
        self.num_classes = num_classes
        self.with_pool = with_pool
        if num_classes > 0:
            self.classifier_conv = nn.Conv2D(512, num_classes, 1)
            self.dropout = nn.Dropout(0.5)
            self.relu = nn.ReLU()
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.relu(self.classifier_conv(self.dropout(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
        return x


model_urls = {
    "squeezenet1_0": (
        "https://paddle-imagenet-models-name.bj.bcebos.com/dygraph/"
        "SqueezeNet1_0_pretrained.pdparams",
        "30b95af60a2178f03cf9b66cd77e1db1"),
    "squeezenet1_1": (
        "https://paddle-imagenet-models-name.bj.bcebos.com/dygraph/"
        "SqueezeNet1_1_pretrained.pdparams",
        "a11250d3a1f91d7131fd095ebbf09eee"),
}


def _squeezenet(version, pretrained, **kwargs):
    model = SqueezeNet(version, **kwargs)
    if pretrained:
        from ._utils import load_pretrained
        load_pretrained(model,
                        f"squeezenet{str(version).replace('.', '_')}",
                        urls=model_urls)
    return model


def squeezenet1_0(pretrained: bool = False, **kwargs) -> SqueezeNet:
    return _squeezenet("1.0", pretrained, **kwargs)


def squeezenet1_1(pretrained: bool = False, **kwargs) -> SqueezeNet:
    return _squeezenet("1.1", pretrained, **kwargs)
