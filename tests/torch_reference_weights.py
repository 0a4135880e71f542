"""Reference weights for a vision model, drawn with numpy by the port's
initializers' laws.

Tests that hold the port's vision models against the JAX package's
build the JAX model with zero parameters, give it these arrays, and
carry its state dict over to the port: the weights come from neither
package's random stream (``tests/test_torch_random_device.py`` checks
those), and the same seed gives the same weights in every process.

The laws, by state-dict entry: a convolution's ``[O, I/g, *k]`` weight
KaimingUniform, U(±√(6 / fan_in)) with fan_in = I/g · Πk, its bias
U(±1 / √fan_in); a ``Linear``'s ``[in, out]`` weight XavierNormal,
N(0, 2 / (in + out)), its bias zero; a batch norm's scale one and shift
zero, its running mean N(0, 0.1²) and variance U(0.5, 1.5), drawn to be
nontrivial.
"""
import numpy as np


def law_arrays(shapes, seed):
    """``{key: float32 array}`` for a state dict given as ``{key:
    shape}``, from ``np.random.default_rng(seed)`` in key order."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in shapes.items():
        shape = tuple(int(s) for s in shape)
        prefix, _, leaf = key.rpartition(".")
        if leaf == "_mean":
            a = rng.standard_normal(shape) * 0.1
        elif leaf == "_variance":
            a = rng.uniform(0.5, 1.5, shape)
        elif f"{prefix}._mean" in shapes:
            a = np.ones(shape) if leaf == "weight" else np.zeros(shape)
        elif leaf == "weight" and len(shape) == 2:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / sum(shape))
        elif leaf == "weight":
            bound = np.sqrt(6.0 / np.prod(shape[1:]))
            a = rng.uniform(-bound, bound, shape)
        elif leaf == "bias":
            w = tuple(shapes[f"{prefix}.weight"])
            if len(w) == 2:
                a = np.zeros(shape)
            else:
                bound = 1.0 / np.sqrt(np.prod(w[1:]))
                a = rng.uniform(-bound, bound, shape)
        else:
            raise KeyError(f"no law for {key} {shape}")
        out[key] = a.astype(np.float32)
    return out
