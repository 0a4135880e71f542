"""What the port's public surface still lacks of the JAX package's.

For the root, ``nn``, ``nn.functional`` and ``linalg``: the public names
of the JAX module (``dir()``) that the port's module does not have,
pinned to an explicit list, each name beside the ROADMAP queue-1 item
that ports it. Names that exist only because the JAX modules import
them (``jax``, ``jnp``, ``np``, ``functools``, ``Tensor``, ``apply_op``
...) are left out. A submodule that another test file imported lazily
shows up in ``dir()`` of its package in some processes and not others:
a module attribute outside the pinned list is not counted.
"""
import types

import pytest

import paddle_tpu as jpaddle
import paddle_tpu.linalg  # noqa: F401
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.linalg  # noqa: F401

# names the JAX modules hold only as their own imports
JAX_ONLY = {"jax", "jnp", "np", "functools", "annotations", "random_mod",
            "Tensor", "apply_op", "convert_dtype"}

# what is left, by module: name -> the ROADMAP queue-1 item that ports it
LEFT = {
    "": {
        "DataParallel": 13, "distributed": 13, "parallel": 15,
        "fusion": 14, "device": 15, "fft": 15,
        "signal": 15, "sparse": 15, "audio": 15, "text": 15,
        "quantization": 15, "distribution": 15,
        "hub": 15, "onnx": 15,
    },
    "nn": {},
    "nn.functional": {},
    "linalg": {},
}


def _module(root, path):
    mod = root
    for part in [p for p in path.split(".") if p]:
        mod = getattr(mod, part)
    return mod


@pytest.mark.parametrize("path", sorted(LEFT), ids=lambda p: p or "root")
def test_the_surface_left_is_pinned(path):
    jm, tm = _module(jpaddle, path), _module(tpaddle, path)
    missing = set()
    for name in dir(jm):
        if name.startswith("_") or name in JAX_ONLY or hasattr(tm, name):
            continue
        if isinstance(getattr(jm, name), types.ModuleType) and \
                name not in LEFT[path]:
            continue
        missing.add(name)
    assert missing == set(LEFT[path]), (
        f"newly missing: {sorted(missing - set(LEFT[path]))}; "
        f"ported since: {sorted(set(LEFT[path]) - missing)}")


def test_the_items_named_are_queued():
    assert {i for left in LEFT.values() for i in left.values()} <= \
        {13, 14, 15}
