"""MobileNetV3 small / large of the port
(``paddle_tpu/vision/models/mobilenetv3.py``): inverted residuals with
squeeze-excite (``Hardsigmoid`` of slope 0.1666667) and ``Hardswish``;
channel counts through ``_make_divisible``."""
from __future__ import annotations

from ... import nn

__all__ = ["MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _SqueezeExcite(nn.Layer):
    def __init__(self, ch, squeeze_ch):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(ch, squeeze_ch, 1)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(squeeze_ch, ch, 1)
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _InvertedResidual(nn.Layer):
    def __init__(self, in_ch, exp_ch, out_ch, kernel, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        act_layer = nn.Hardswish if act == "hardswish" else nn.ReLU
        if exp_ch != in_ch:
            layers += [nn.Conv2D(in_ch, exp_ch, 1, bias_attr=False),
                       nn.BatchNorm2D(exp_ch), act_layer()]
        layers += [nn.Conv2D(exp_ch, exp_ch, kernel, stride=stride,
                             padding=kernel // 2, groups=exp_ch,
                             bias_attr=False),
                   nn.BatchNorm2D(exp_ch), act_layer()]
        if use_se:
            layers.append(_SqueezeExcite(exp_ch,
                                         _make_divisible(exp_ch // 4)))
        layers += [nn.Conv2D(exp_ch, out_ch, 1, bias_attr=False),
                   nn.BatchNorm2D(out_ch)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


# (kernel, expanded, out, use_se, act, stride) per the paper's tables
_SMALL = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]
_LARGE = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]


class MobileNetV3(nn.Layer):
    def __init__(self, config, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        in_ch = _make_divisible(16 * scale)
        self.conv_stem = nn.Sequential(
            nn.Conv2D(3, in_ch, 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(in_ch), nn.Hardswish(),
        )
        blocks = []
        for k, exp, out, se, act, s in config:
            exp_ch = _make_divisible(exp * scale)
            out_ch = _make_divisible(out * scale)
            blocks.append(_InvertedResidual(in_ch, exp_ch, out_ch, k, s,
                                            se, act))
            in_ch = out_ch
        self.blocks = nn.Sequential(*blocks)
        last_conv = _make_divisible(6 * in_ch)
        self.conv_last = nn.Sequential(
            nn.Conv2D(in_ch, last_conv, 1, bias_attr=False),
            nn.BatchNorm2D(last_conv), nn.Hardswish(),
        )
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_conv, last_channel), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_channel, num_classes),
            )

    def forward(self, x):
        x = self.conv_last(self.blocks(self.conv_stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_SMALL, _make_divisible(1024 * scale), scale,
                         num_classes, with_pool)


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_LARGE, _make_divisible(1280 * scale), scale,
                         num_classes, with_pool)


model_urls = {
    "mobilenet_v3_small_x1.0": (
        "https://paddle-hapi.bj.bcebos.com/models/"
        "mobilenet_v3_small_x1.0.pdparams",
        "34fe0e7c1f8b00b2b056ad6788d0590c"),
    "mobilenet_v3_large_x1.0": (
        "https://paddle-hapi.bj.bcebos.com/models/"
        "mobilenet_v3_large_x1.0.pdparams",
        "118db5792b4e183b925d8e8e334db3df"),
}


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    model = MobileNetV3Small(scale=scale, **kwargs)
    if pretrained:
        from ._utils import load_pretrained
        from ._utils import scale_suffix
        load_pretrained(model,
                        f"mobilenet_v3_small_x{scale_suffix(scale)}",
                        urls=model_urls)
    return model


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    model = MobileNetV3Large(scale=scale, **kwargs)
    if pretrained:
        from ._utils import load_pretrained
        from ._utils import scale_suffix
        load_pretrained(model,
                        f"mobilenet_v3_large_x{scale_suffix(scale)}",
                        urls=model_urls)
    return model
