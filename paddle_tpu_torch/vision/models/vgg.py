"""VGG 11/13/16/19 of the port (``paddle_tpu/vision/models/vgg.py``),
with or without batch norm; ``AdaptiveAvgPool2D((7, 7))`` before the
classifier."""
from ... import nn

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False):
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(kernel_size=2, stride=2))
        else:
            conv2d = nn.Conv2D(in_channels, v, kernel_size=3, padding=1)
            if batch_norm:
                layers += [conv2d, nn.BatchNorm2D(v), nn.ReLU()]
            else:
                layers += [conv2d, nn.ReLU()]
            in_channels = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.classifier(x)
        return x


# ref: vision/models/vgg.py model_urls (bn variants have no published
# weights — pretrained=True on them fails loudly via load_pretrained)
model_urls = {
    "vgg16": ("https://paddle-hapi.bj.bcebos.com/models/vgg16.pdparams",
              "89bbffc0f87d260be9b8cdc169c991c4"),
    "vgg19": ("https://paddle-hapi.bj.bcebos.com/models/vgg19.pdparams",
              "23b18bb13d8894f60f54e642be79a0dd"),
}


def _vgg(cfg, batch_norm=False, pretrained=False, arch=None, **kwargs):
    model = VGG(make_layers(cfgs[cfg], batch_norm=batch_norm), **kwargs)
    if pretrained:
        from ._utils import load_pretrained
        # bn variants have no published artifact: the _bn-suffixed key
        # misses the table before any file is looked for
        key = (arch or "?") + ("_bn" if batch_norm else "")
        load_pretrained(model, key, urls=model_urls)
    return model


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, arch="vgg11", **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, arch="vgg13", **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, arch="vgg16", **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, arch="vgg19", **kwargs)
