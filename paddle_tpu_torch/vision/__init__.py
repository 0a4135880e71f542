"""``paddle.vision`` of the port: the model zoo (``models``), the
numpy transforms, the synthetic datasets, the detection and ROI ops
(``ops``) and the image backend switch."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401
from .image import (  # noqa: F401
    get_image_backend, image_load, set_image_backend,
)
