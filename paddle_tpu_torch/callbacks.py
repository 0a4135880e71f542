"""``paddle.callbacks``: the hapi callbacks (``hapi/callbacks.py``)."""
from .hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, History, LRScheduler, MetricsLogger,
    ModelCheckpoint, ProgBarLogger, VisualDL,
)
