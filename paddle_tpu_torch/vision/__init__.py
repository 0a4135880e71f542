"""``paddle.vision`` of the port: the ResNet family, the numpy
transforms, the synthetic datasets and the image backend switch.

The rest of the JAX package's vision tree (the other models, ``ops``,
``detection_ops``) is not ported yet.
"""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import transforms  # noqa: F401
from .image import (  # noqa: F401
    get_image_backend, image_load, set_image_backend,
)
