"""DenseNet 121/161/169/201/264 of the port
(``paddle_tpu/vision/models/densenet.py``): bn_size bottlenecks,
halving transitions with ``AvgPool2D(2, 2)``."""
from __future__ import annotations

from ... import concat, nn

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CONFIGS = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class _DenseLayer(nn.Layer):
    def __init__(self, in_ch, growth_rate, bn_size, dropout):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(in_ch)
        self.conv1 = nn.Conv2D(in_ch, bn_size * growth_rate, 1,
                               bias_attr=False)
        self.bn2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return concat([x, out], axis=1)


class _Transition(nn.Layer):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.bn = nn.BatchNorm2D(in_ch)
        self.relu = nn.ReLU()
        self.conv = nn.Conv2D(in_ch, out_ch, 1, bias_attr=False)
        self.pool = nn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(nn.Layer):
    def __init__(self, layers: int = 121, bn_size: int = 4,
                 dropout: float = 0.0, num_classes: int = 1000,
                 with_pool: bool = True):
        super().__init__()
        if layers not in _CONFIGS:
            raise ValueError(
                f"layers must be one of {sorted(_CONFIGS)}, got {layers}")
        num_init, growth, block_cfg = _CONFIGS[layers]
        self.stem = nn.Sequential(
            nn.Conv2D(3, num_init, 7, stride=2, padding=3, bias_attr=False),
            nn.BatchNorm2D(num_init), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1),
        )
        blocks = []
        ch = num_init
        for bi, n_layers in enumerate(block_cfg):
            for _ in range(n_layers):
                blocks.append(_DenseLayer(ch, growth, bn_size, dropout))
                ch += growth
            if bi != len(block_cfg) - 1:
                blocks.append(_Transition(ch, ch // 2))
                ch //= 2
        self.blocks = nn.Sequential(*blocks)
        self.bn_final = nn.BatchNorm2D(ch)
        self.relu = nn.ReLU()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.relu(self.bn_final(self.blocks(self.stem(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


model_urls = {
    "densenet121": ("https://paddle-imagenet-models-name.bj.bcebos.com/"
                    "dygraph/DenseNet121_pretrained.pdparams",
                    "db1b239ed80a905290fd8b01d3af08e4"),
    "densenet161": ("https://paddle-imagenet-models-name.bj.bcebos.com/"
                    "dygraph/DenseNet161_pretrained.pdparams",
                    "62158869cb315098bd25ddbfd308a853"),
    "densenet169": ("https://paddle-imagenet-models-name.bj.bcebos.com/"
                    "dygraph/DenseNet169_pretrained.pdparams",
                    "82cc7c635c3f19098c748850efb2d796"),
    "densenet201": ("https://paddle-imagenet-models-name.bj.bcebos.com/"
                    "dygraph/DenseNet201_pretrained.pdparams",
                    "16ca29565a7712329cf9e36e02caaf58"),
    "densenet264": ("https://paddle-imagenet-models-name.bj.bcebos.com/"
                    "dygraph/DenseNet264_pretrained.pdparams",
                    "3270ce516b85370bba88cfdd9f60bff4"),
}


def _densenet(layers, pretrained, **kwargs):
    model = DenseNet(layers, **kwargs)
    if pretrained:
        from ._utils import load_pretrained
        load_pretrained(model, f"densenet{layers}", urls=model_urls)
    return model


def densenet121(pretrained: bool = False, **kwargs) -> DenseNet:
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained: bool = False, **kwargs) -> DenseNet:
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained: bool = False, **kwargs) -> DenseNet:
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained: bool = False, **kwargs) -> DenseNet:
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained: bool = False, **kwargs) -> DenseNet:
    return _densenet(264, pretrained, **kwargs)
