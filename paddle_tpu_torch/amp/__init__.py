"""Automatic mixed precision of the port: ``GradScaler``.

``auto_cast`` / ``decorate`` are not ported yet: the JAX package's
``auto_cast`` hooks its op dispatcher (``apply_op``), which the port
does not have until its op registry is ported.
"""
from .grad_scaler import GradScaler  # noqa: F401
