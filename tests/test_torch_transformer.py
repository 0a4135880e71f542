"""The port's ``nn.Transformer`` (encoder, decoder, masks) against the JAX
package's, on the CPU.

A JAX ``Transformer`` of 2 + 2 layers, d_model 128, 2 heads, dropout 0
gives its parameters to the port's (``convert.state_dict_from_jax``,
which transposes the Linear weights): the decoder's output for a source
of 12 tokens and a target of 7 under ``generate_square_subsequent_mask``
(the decoder's self-attention takes the masked sdpa; the encoder's and
the cross-attention, 7 queries against 12 keys, the flash walk) within
1e-5·(1 + |ref|), and the gradients of ``Σ out · w`` with respect to the
inputs and every parameter within 1e-4·(1 + |ref|). Also the pre-norm
stacks, ``custom_encoder`` / ``custom_decoder``, ``bias_attr=False`` and
``weight_attr`` initializers, and the mask.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.jit.api import functionalize
from paddle_tpu_torch.convert import linear_weight_names, state_dict_from_jax
from test_torch_tensor import port_on_cpu  # noqa: F401

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) - tol * (1 + np.abs(want))
    assert err.max() <= 0, (what, float(np.abs(got - want).max()))


def _pair(normalize_before=False, seed=0):
    jpaddle.seed(seed)
    jm = jpaddle.nn.Transformer(128, 2, 2, 2, 256, dropout=0.0,
                                normalize_before=normalize_before)
    tm = tpaddle.nn.Transformer(128, 2, 2, 2, 256, dropout=0.0,
                                normalize_before=normalize_before,
                                device="cpu")
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm.load_state_dict(state_dict_from_jax(arrays, model=tm))
    return jm, tm, arrays


def _data():
    r = np.random.default_rng(1)
    return (r.standard_normal((2, 12, 128)).astype(np.float32),
            r.standard_normal((2, 7, 128)).astype(np.float32),
            r.standard_normal((2, 7, 128)).astype(np.float32))


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_norm", "pre_norm"])
def test_transformer_matches_jax(normalize_before):
    jm, tm, arrays = _pair(normalize_before)
    src, tgt, w = _data()
    jmask = jpaddle.nn.Transformer.generate_square_subsequent_mask(7)
    tmask = tpaddle.nn.Transformer.generate_square_subsequent_mask(7)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask._data))
    assert tmask.numpy().dtype == np.bool_

    # JAX: out and the vjp of Σ out·w over (params, src, tgt)
    fwd, params, buffers = functionalize(jm)

    def f(p, s, t):
        return fwd(p, buffers, s, t, tgt_mask=jmask._data)[0]
    out, vjp = jax.vjp(f, params, jnp.asarray(src), jnp.asarray(tgt))
    gp, gs, gt = vjp(jnp.asarray(w))

    ts = torch.from_numpy(src).requires_grad_()
    tt = torch.from_numpy(tgt).requires_grad_()
    got = tm(ts, tt, tgt_mask=tmask._t)
    _close(got.detach().numpy(), np.asarray(out), FWD_TOL, "out")
    names = [n for n, _ in torch.nn.Module.named_parameters(tm)]
    leaves = [p for _, p in torch.nn.Module.named_parameters(tm)]
    grads = torch.autograd.grad(got, [ts, tt] + leaves,
                                torch.from_numpy(w))
    _close(grads[0].numpy(), np.asarray(gs), GRAD_TOL, "d src")
    _close(grads[1].numpy(), np.asarray(gt), GRAD_TOL, "d tgt")
    lin = linear_weight_names(tm)
    for name, g in zip(names, grads[2:]):
        want = np.asarray(gp[name])
        if name in lin:
            want = want.T
        _close(g.numpy(), want, GRAD_TOL, name)


def test_custom_stacks_and_attributes():
    enc = tpaddle.nn.TransformerEncoder(tpaddle.nn.TransformerEncoderLayer(
        16, 2, 32, dropout=0.0, device="cpu"), 1)
    dec = tpaddle.nn.TransformerDecoder(tpaddle.nn.TransformerDecoderLayer(
        16, 2, 32, dropout=0.0, device="cpu"), 3)
    t = tpaddle.nn.Transformer(16, 2, custom_encoder=enc,
                               custom_decoder=dec)
    assert t.encoder is enc and t.decoder is dec
    assert len(t.decoder.layers) == 3
    # bias_attr=False: no biases anywhere; a weight initializer draws the
    # [in, out] weight as the JAX Linear does
    nb = tpaddle.nn.TransformerDecoderLayer(
        16, 2, 32, bias_attr=False,
        weight_attr=tpaddle.nn.initializer.Constant(0.5), device="cpu")
    names = [n for n, _ in torch.nn.Module.named_parameters(nb)]
    assert not [n for n in names if n.endswith(".bias") and "norm" not in n]
    assert float(nb.linear1.weight.min()) == float(
        nb.linear1.weight.max()) == 0.5
    jpaddle.seed(2)
    jl = jpaddle.nn.TransformerDecoderLayer(16, 2, 32, bias_attr=False)
    assert sorted(n for n, _ in jl.named_parameters()) == sorted(names)
    x = tpaddle.to_tensor(np.ones((1, 3, 16), np.float32))
    mem = tpaddle.to_tensor(np.ones((1, 5, 16), np.float32))
    out = t(mem, x)
    assert isinstance(out, tpaddle.Tensor) and out.shape == [1, 3, 16]
