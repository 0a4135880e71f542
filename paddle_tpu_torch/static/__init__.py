"""``paddle.static`` of the port: ``InputSpec`` only, as the JAX
package's ``static`` exports it (``paddle_tpu/static/__init__.py``).
The rest of ``static`` (``Program``, ``Executor``, ``data`` and the
static-graph tooling) is ROADMAP item 15."""
from ..jit.api import InputSpec  # noqa: F401

__all__ = ["InputSpec"]
