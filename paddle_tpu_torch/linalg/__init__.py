"""``paddle.linalg`` of the port: the linear-algebra ops, re-exported
from ``ops.linalg`` as the JAX package's ``linalg`` re-exports its own."""
from ..ops.linalg import *  # noqa: F401,F403
from ..ops.linalg import __all__  # noqa: F401
