"""ShuffleNetV2 of the port
(``paddle_tpu/vision/models/shufflenetv2.py``), every scale and the
swish variant: channel split, depthwise convs and ``ChannelShuffle``."""
from __future__ import annotations

from ... import concat, nn

__all__ = [
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "shufflenet_v2_swish",
]

_STAGE_OUT = {
    0.25: (24, 24, 48, 96, 512),
    0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}
_REPEATS = (4, 8, 4)


def _act(name):
    return nn.Swish() if name == "swish" else nn.ReLU()


class _ShuffleUnit(nn.Layer):
    """stride-1 unit: channel split, transform right half, shuffle."""

    def __init__(self, ch, act):
        super().__init__()
        branch = ch // 2
        self.branch = nn.Sequential(
            nn.Conv2D(branch, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), _act(act),
            nn.Conv2D(branch, branch, 3, padding=1, groups=branch,
                      bias_attr=False),
            nn.BatchNorm2D(branch),
            nn.Conv2D(branch, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), _act(act),
        )
        self.shuffle = nn.ChannelShuffle(2)

    def forward(self, x):
        c = x.shape[1] // 2
        left, right = x[:, :c], x[:, c:]
        out = concat([left, self.branch(right)], axis=1)
        return self.shuffle(out)


class _ShuffleDownUnit(nn.Layer):
    """stride-2 unit: both branches transform, output doubles channels."""

    def __init__(self, in_ch, out_ch, act):
        super().__init__()
        branch = out_ch // 2
        self.left = nn.Sequential(
            nn.Conv2D(in_ch, in_ch, 3, stride=2, padding=1, groups=in_ch,
                      bias_attr=False),
            nn.BatchNorm2D(in_ch),
            nn.Conv2D(in_ch, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), _act(act),
        )
        self.right = nn.Sequential(
            nn.Conv2D(in_ch, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), _act(act),
            nn.Conv2D(branch, branch, 3, stride=2, padding=1, groups=branch,
                      bias_attr=False),
            nn.BatchNorm2D(branch),
            nn.Conv2D(branch, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), _act(act),
        )
        self.shuffle = nn.ChannelShuffle(2)

    def forward(self, x):
        out = concat([self.left(x), self.right(x)], axis=1)
        return self.shuffle(out)


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale: float = 1.0, act: str = "relu",
                 num_classes: int = 1000, with_pool: bool = True):
        super().__init__()
        if scale not in _STAGE_OUT:
            raise ValueError(
                f"scale must be one of {sorted(_STAGE_OUT)}, got {scale}")
        chans = _STAGE_OUT[scale]
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, chans[0], 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(chans[0]), _act(act),
        )
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        stages = []
        in_ch = chans[0]
        for out_ch, repeat in zip(chans[1:4], _REPEATS):
            units = [_ShuffleDownUnit(in_ch, out_ch, act)]
            units += [_ShuffleUnit(out_ch, act) for _ in range(repeat - 1)]
            stages.append(nn.Sequential(*units))
            in_ch = out_ch
        self.stages = nn.Sequential(*stages)
        self.conv_last = nn.Sequential(
            nn.Conv2D(in_ch, chans[4], 1, bias_attr=False),
            nn.BatchNorm2D(chans[4]), _act(act),
        )
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(chans[4], num_classes)

    def forward(self, x):
        x = self.conv_last(self.stages(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


model_urls = {
    "shufflenet_v2_x0_25": (
        "https://paddle-hapi.bj.bcebos.com/models/"
        "shufflenet_v2_x0_25.pdparams",
        "1e509b4c140eeb096bb16e214796d03b"),
    "shufflenet_v2_x0_33": (
        "https://paddle-hapi.bj.bcebos.com/models/"
        "shufflenet_v2_x0_33.pdparams",
        "3d7b3ab0eaa5c0927ff1026d31b729bd"),
    "shufflenet_v2_x0_5": (
        "https://paddle-hapi.bj.bcebos.com/models/"
        "shufflenet_v2_x0_5.pdparams",
        "5e5cee182a7793c4e4c73949b1a71bd4"),
    "shufflenet_v2_x1_0": (
        "https://paddle-hapi.bj.bcebos.com/models/"
        "shufflenet_v2_x1_0.pdparams",
        "122d42478b9e81eb49f8a9ede327b1a4"),
    "shufflenet_v2_x1_5": (
        "https://paddle-hapi.bj.bcebos.com/models/"
        "shufflenet_v2_x1_5.pdparams",
        "faced5827380d73531d0ee027c67826d"),
    "shufflenet_v2_x2_0": (
        "https://paddle-hapi.bj.bcebos.com/models/"
        "shufflenet_v2_x2_0.pdparams",
        "cd3dddcd8305e7bcd8ad14d1c69a5784"),
    "shufflenet_v2_swish": (
        "https://paddle-hapi.bj.bcebos.com/models/"
        "shufflenet_v2_swish.pdparams",
        "adde0aa3b023e5b0c94a68be1c394b84"),
}


def _shufflenet(scale, act, pretrained, arch=None, **kwargs):
    model = ShuffleNetV2(scale, act, **kwargs)
    if pretrained:
        from ._utils import load_pretrained
        load_pretrained(model, arch or "?", urls=model_urls)
    return model


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return _shufflenet(0.25, "relu", pretrained,
                       arch="shufflenet_v2_x0_25", **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return _shufflenet(0.33, "relu", pretrained,
                       arch="shufflenet_v2_x0_33", **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return _shufflenet(0.5, "relu", pretrained,
                       arch="shufflenet_v2_x0_5", **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return _shufflenet(1.0, "relu", pretrained,
                       arch="shufflenet_v2_x1_0", **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return _shufflenet(1.5, "relu", pretrained,
                       arch="shufflenet_v2_x1_5", **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return _shufflenet(2.0, "relu", pretrained,
                       arch="shufflenet_v2_x2_0", **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    return _shufflenet(1.0, "swish", pretrained,
                       arch="shufflenet_v2_swish", **kw)
