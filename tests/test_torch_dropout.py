"""The port's dropout against the JAX package's, on the CPU.

``F.dropout`` in its main mode draws the JAX package's hash mask (a
murmur3 finalizer over the element index and a uint32 seed): from the
same seed the port's mask is the JAX mask bit for bit. The test learns
the seed JAX drew by wrapping ``_rng_key_tensor`` and folding the key
with ``derive_seed``, as the JAX dropout does, and hands it to the
port as a key tensor whose last word is that seed: the port's dropout
folds the key with its own ``derive_seed`` on the tensor's device. The other modes (eval, ``p = 0``, ``p = 1``,
``downscale_in_infer``, ``axis``) and the ``Dropout`` layer follow the
paddle semantics.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional.common as jcommon
from paddle_tpu.core import random as jrandom
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.common import hash_keep_mask


def _jax_dropout_and_seed(x, p, monkeypatch):
    seen = []
    real = jcommon._rng_key_tensor

    def spy():
        t = real()
        seen.append(int(jrandom.derive_seed(t._data, jnp.uint32)))
        return t

    monkeypatch.setattr(jcommon, "_rng_key_tensor", spy)
    out = paddle.nn.functional.dropout(paddle.to_tensor(x), p,
                                       training=True)
    return np.asarray(out._data), seen[-1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_hash_mask_is_the_jax_mask_bit_for_bit(dtype, p, monkeypatch):
    """Same uint32 seed, same mask, same values: kept elements are
    divided by ``1 - p`` (in bf16, by bf16(1 - p), as JAX's weak scalar
    is rounded to the array's dtype)."""
    rng = np.random.default_rng(int(p * 10))
    x = rng.standard_normal((3, 17, 40)).astype(np.float32) + 3.0
    jx = np.asarray(jnp.asarray(x, getattr(jnp, dtype)))
    want, seed = _jax_dropout_and_seed(jx, p, monkeypatch)
    monkeypatch.setattr(trandom, "next_key", lambda device=None: torch.tensor(
        [0, seed], device=device))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = F.dropout(tx, p, training=True)
    assert got.dtype == tx.dtype
    want32 = want.astype(np.float32)
    np.testing.assert_array_equal(got.float().numpy() != 0, want32 != 0)
    np.testing.assert_array_equal(got.float().numpy(), want32)
    keep = hash_keep_mask(x.shape, p, torch.tensor(seed))
    np.testing.assert_array_equal(keep.numpy(), want32 != 0)
    sigma = np.sqrt(p * (1 - p) / x.size)
    assert abs(keep.float().mean().item() - (1 - p)) <= 4 * sigma


def test_eval_zero_one_and_downscale_modes():
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0)) + 5
    assert F.dropout(x, 0.3, training=False) is x
    assert F.dropout(x, 0.0, training=True) is x
    xg = x.clone().requires_grad_()
    zero = F.dropout(xg, 1.0, training=True)
    assert not zero.any()
    zero.sum().backward()
    assert not xg.grad.any()           # zero (not NaN) gradients
    torch.testing.assert_close(
        F.dropout(x, 0.3, training=False, mode="downscale_in_infer"),
        x * 0.7, rtol=0, atol=0)
    trandom.seed(3)
    down = F.dropout(x, 0.5, training=True, mode="downscale_in_infer")
    kept = down != 0
    assert torch.equal(down[kept], x[kept]) and 0 < kept.sum() < x.numel()
    trandom.seed(3)
    assert torch.equal(
        F.dropout(x, 0.5, training=True, mode="downscale_in_infer"), down)
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, 0.5, mode="scale")


def test_axis_mode_shares_the_mask_and_the_layer_follows_train_eval():
    x = torch.ones(5, 64)
    out = F.dropout(x, 0.5, axis=1, training=True)
    assert torch.equal(out, out[:1].expand_as(out))   # one mask per column
    assert set(out.unique().tolist()) <= {0.0, 2.0}
    layer = Dropout(0.4)
    trandom.seed(9)
    a = layer(x)
    trandom.seed(9)
    assert torch.equal(layer(x), a) and not torch.equal(a, x)
    assert torch.equal(layer.eval()(x), x)


def test_seeds_are_drawn_on_the_host_and_replay_from_the_state():
    """The dropout keys (the flash kernels' key, the hash dropout's
    seed) and the host draws' seeds replay from the ``(seed, counter)``
    state; the hash seed is a 0-dim tensor on the key's device."""
    trandom.seed(5)
    state = trandom.get_rng_state()

    def draw():
        key = trandom.next_key("cpu")
        hseed = trandom.derive_seed(trandom.next_key("cpu"), "uint32")
        return key, hseed, trandom.device_generator("cpu").initial_seed()
    a = draw()
    assert trandom.get_rng_state() == (5, 3)
    trandom.set_rng_state(state)
    b = draw()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[2] == b[2] and 0 <= a[2] < 2 ** 64
    assert a[0].dtype == torch.int64 and a[0].shape == (2,)
    assert a[1].dim() == 0 and 0 <= int(a[1]) < 2 ** 32
    assert isinstance(trandom.default_generator(), trandom.Generator)
