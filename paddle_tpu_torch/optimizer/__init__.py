"""Optimizers of the port, their LR schedulers and the fused step."""
from .optimizer import (  # noqa: F401
    Optimizer, SGD, Momentum, Adagrad, Adam, AdamW, Adamax, RMSProp, Lamb,
    Adadelta,
)
from .extra import ASGD, LBFGS, NAdam, RAdam, Rprop  # noqa: F401
from . import fused_step  # noqa: F401
from . import lr  # noqa: F401
