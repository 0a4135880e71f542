"""MobileNetV1 and MobileNetV2 of the port
(``paddle_tpu/vision/models/mobilenet.py``): depthwise-separable blocks
and inverted residuals (depthwise convs are ``Conv2D`` with ``groups``
equal to the channels); the V2 classifier's ``Dropout(0.2)`` is the
hash dropout, so a captured ``TrainStep`` holds it."""
from ... import nn

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


class ConvBNLayer(nn.Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1):
        super().__init__()
        self._conv = nn.Conv2D(in_channels, out_channels, kernel_size,
                               stride=stride, padding=padding, groups=groups,
                               bias_attr=False)
        self._norm = nn.BatchNorm2D(out_channels)
        self._act = nn.ReLU()

    def forward(self, x):
        return self._act(self._norm(self._conv(x)))


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups,
                 stride, scale):
        super().__init__()
        self._dw = ConvBNLayer(in_channels, int(out_channels1 * scale), 3,
                               stride=stride, padding=1,
                               groups=int(num_groups * scale))
        self._pw = ConvBNLayer(int(out_channels1 * scale),
                               int(out_channels2 * scale), 1)

    def forward(self, x):
        return self._pw(self._dw(x))


class MobileNetV1(nn.Layer):
    """ref: vision/models/mobilenetv1.py."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = scale
        self.conv1 = ConvBNLayer(3, int(32 * s), 3, stride=2, padding=1)
        cfg = [(32, 32, 64, 1), (64, 64, 128, 2), (128, 128, 128, 1),
               (128, 128, 256, 2), (256, 256, 256, 1), (256, 256, 512, 2)] \
            + [(512, 512, 512, 1)] * 5 + [(512, 512, 1024, 2),
                                          (1024, 1024, 1024, 1)]
        blocks = []
        for in_c, c1, c2, stride in cfg:
            blocks.append(DepthwiseSeparable(
                int(in_c * s), c1, c2, in_c, stride, s))
        self.blocks = nn.Sequential(*blocks)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * s), num_classes)

    def forward(self, x):
        x = self.conv1(x)
        x = self.blocks(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.fc(x)
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden_dim, 1))
        layers += [
            ConvBNLayer(hidden_dim, hidden_dim, 3, stride=stride, padding=1,
                        groups=hidden_dim),
            nn.Conv2D(hidden_dim, oup, 1, bias_attr=False),
            nn.BatchNorm2D(oup),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res_connect else out


class MobileNetV2(nn.Layer):
    """ref: vision/models/mobilenetv2.py."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = int(32 * scale)
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        features = [ConvBNLayer(3, input_channel, 3, stride=2, padding=1)]
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t))
                input_channel = out_c
        self.last_channel = int(1280 * max(1.0, scale))
        features.append(ConvBNLayer(input_channel, self.last_channel, 1))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(self.last_channel, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.classifier(x)
        return x


# ref: mobilenetv1.py / mobilenetv2.py model_urls (published only at
# scale 1.0; other scales fail loudly)
model_urls = {
    "mobilenetv1_1.0": (
        "https://paddle-hapi.bj.bcebos.com/models/mobilenetv1_1.0.pdparams",
        "3033ab1975b1670bef51545feb65fc45"),
    "mobilenetv2_1.0": (
        "https://paddle-hapi.bj.bcebos.com/models/mobilenet_v2_x1.0.pdparams",
        "0340af0a901346c8d46f4529882fb63d"),
}


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    model = MobileNetV1(scale=scale, **kwargs)
    if pretrained:
        from ._utils import load_pretrained
        from ._utils import scale_suffix
        load_pretrained(model, f"mobilenetv1_{scale_suffix(scale)}",
                        urls=model_urls)
    return model


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    model = MobileNetV2(scale=scale, **kwargs)
    if pretrained:
        from ._utils import load_pretrained
        from ._utils import scale_suffix
        load_pretrained(model, f"mobilenetv2_{scale_suffix(scale)}",
                        urls=model_urls)
    return model
