"""Whole-step entries of the port: ``TrainStep`` (eager) and
``CapturedStep`` (a step as one CUDA graph per signature, behind
``hapi.Model``)."""
from .api import TrainStep  # noqa: F401
from .sot import BucketPolicy, CapturedStep  # noqa: F401
