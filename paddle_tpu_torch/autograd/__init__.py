"""``paddle.autograd`` of the port: ``backward`` / ``grad`` and the grad
modes (``core.autograd``), ``PyLayer`` with its context and
``saved_tensors_hooks``, and the functional ``jacobian`` / ``hessian``
/ ``vjp`` / ``jvp`` (``torch.func``)."""
from ..core.autograd import backward, enable_grad, grad, no_grad  # noqa: F401
from .functional import hessian, jacobian, jvp, vjp  # noqa: F401
from .py_layer import (  # noqa: F401
    PyLayer, PyLayerContext, saved_tensors_hooks)

__all__ = ["backward", "grad", "no_grad", "enable_grad", "PyLayer",
           "PyLayerContext", "saved_tensors_hooks", "jacobian", "hessian",
           "vjp", "jvp"]
