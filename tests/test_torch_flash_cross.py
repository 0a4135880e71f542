"""Flash attention over unequal query and key lengths, on the CPU.

The port's ``scaled_dot_product_attention``, ``flash_attention`` and
``MultiHeadAttention`` (the flash kernels' plain walk on the CPU) against
the JAX package's oracle ``_sdpa_xla``, f32, for queries fewer than keys
(cross-attention, a KV-cache step) and more than keys, causal and not:
the output within 1e-5·(1 + |ref|), the gradients of ``Σ out · w`` (``w``
a fixed random weighting) within 1e-4·(1 + |ref|). Causal puts the
diagonal at j <= i + Lk - Lq; a causal row with no allowed key gets the
oracle's answer, the mean of V's rows, and its gradient. With dropout
the walk keeps the pairs of ``flash_dropout_keep_mask(..., Lk=)``: it
equals the port's ``sdpa_reference`` (which draws that mask) on the same
key. The kernels' plain versions leave a row with no allowed key at zero
(lse -1e30), which ``FlashAttention`` fills.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.ops.pallas.flash_attention import _sdpa_xla
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.nn.functional import sdpa_reference
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from test_torch_tensor import port_on_cpu  # noqa: F401

FWD_TOL, GRAD_TOL = 1e-5, 1e-4

# (Lq, Lk, causal): the fault's rows (8/24 both ways, a cache step, 24/8,
# 300/200) and the causal cases with queries outnumbering keys
CASES = [(8, 24, False), (8, 24, True), (1, 17, False), (1, 17, True),
         (24, 8, False), (24, 8, True), (300, 200, False),
         (300, 200, True), (70, 130, True), (130, 70, True)]


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) - tol * (1 + np.abs(want))
    assert err.max() <= 0, (what, float(np.abs(got - want).max()))


def _inputs(Lq, Lk, B=2, H=2, D=64, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Lq, H, D)).astype(np.float32)
    k = r.standard_normal((B, Lk, H, D)).astype(np.float32)
    v = r.standard_normal((B, Lk, H, D)).astype(np.float32)
    w = r.standard_normal((B, Lq, H, D)).astype(np.float32)
    return q, k, v, w


def _jax_ref(q, k, v, w, causal):
    def f(a, b, c):
        return _sdpa_xla(a, b, c, causal=causal)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(w))]


def _port(fn, q, k, v, w):
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*xs)
    out = out._t if isinstance(out, tpaddle.Tensor) else out
    grads = torch.autograd.grad(out, xs, torch.from_numpy(w))
    return out.detach().numpy(), [g.numpy() for g in grads]


ENTRIES = {
    "scaled_dot_product_attention": lambda causal: (
        lambda a, b, c: tpaddle.nn.functional.scaled_dot_product_attention(
            a, b, c, is_causal=causal)),
    "flash_attention": lambda causal: (
        lambda a, b, c: tpaddle.nn.functional.flash_attention(
            a, b, c, causal=causal)[0]),
    "kernels_autograd": lambda causal: (
        lambda a, b, c: tfa.flash_attention(a, b, c, causal)),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("Lq,Lk,causal", CASES,
                         ids=[f"{a}x{b}{'_causal' if c else ''}"
                              for a, b, c in CASES])
def test_cross_length_attention_matches_the_oracle(entry, Lq, Lk, causal):
    q, k, v, w = _inputs(Lq, Lk, seed=Lq * 1000 + Lk)
    want, wgrads = _jax_ref(q, k, v, w, causal)
    got, grads = _port(ENTRIES[entry](causal), q, k, v, w)
    _close(got, want, FWD_TOL, "out")
    for name, g, r in zip(("dq", "dk", "dv"), grads, wgrads):
        _close(g, r, GRAD_TOL, name)


def test_a_row_with_no_allowed_key_gets_the_mean_of_v():
    """Causal, 6 queries against 4 keys: rows 0 and 1 see no key. The
    oracle softmaxes equal -1e30 logits there: the plain mean of V, and
    no gradient into q or k from those rows."""
    q, k, v, w = _inputs(6, 4, seed=3)
    got, grads = _port(ENTRIES["kernels_autograd"](True), q, k, v, w)
    np.testing.assert_allclose(got[:, :2], np.broadcast_to(
        v.mean(axis=1, keepdims=True), got[:, :2].shape), atol=1e-6)
    w0 = w.copy()
    w0[:, 2:] = 0.0                       # only the empty rows' weights
    _, g0 = _port(ENTRIES["kernels_autograd"](True), q, k, v, w0)
    assert np.abs(g0[0]).max() == 0 and np.abs(g0[1]).max() == 0
    np.testing.assert_allclose(g0[2], np.broadcast_to(
        w0[:, :2].sum(axis=1, keepdims=True) / 4, g0[2].shape), atol=1e-6)
    # the kernels' plain forward leaves those rows at zero, lse -1e30
    out, lse = tfa.flash_attention_fwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    assert float(out[:, :2].abs().max()) == 0.0
    assert bool((lse[..., :2] == -1e30).all())


@pytest.mark.parametrize("Lq,Lk,causal", [(8, 24, False), (24, 8, True),
                                          (1, 70, True), (70, 130, True)])
def test_the_walks_dropout_keeps_the_keep_mask_pairs(Lq, Lk, causal):
    """The walk, its backward and FlashAttention drop the pairs of
    flash_dropout_keep_mask(seed, B, H, Lq, p, Lk=Lk): they equal the
    plain sdpa, which draws that mask, on the same seed."""
    q, k, v, w = _inputs(Lq, Lk, seed=11)
    seed, p = torch.tensor([3, 2], dtype=torch.int64), 0.2   # a key tensor
    keep = tfa.flash_dropout_keep_mask(seed, 2, 2, Lq, p, Lk=Lk)
    assert keep.shape == (2, 2, Lq, Lk)
    assert 0.7 < float(keep.float().mean()) < 0.9
    got, grads = _port(lambda a, b, c: tfa.flash_attention(
        a, b, c, causal, dropout_p=p, seed=seed), q, k, v, w)
    want, wgrads = _port(lambda a, b, c: sdpa_reference(
        a, b, c, causal=causal, dropout_p=p, seed=seed), q, k, v, w)
    _close(got, want, FWD_TOL, "out")
    for name, g, r in zip(("dq", "dk", "dv"), grads, wgrads):
        _close(g, r, GRAD_TOL, name)


def test_checks_take_unequal_lengths_and_refuse_the_rest():
    bf = torch.bfloat16
    q = torch.zeros(2, 8, 2, 64, dtype=bf)
    k = torch.zeros(2, 24, 2, 64, dtype=bf)
    assert tfa.takes_tma(q, k, k, torch.zeros_like(q)) is True
    assert tfa.takes_tma(q, k, k[:, :5]) is False          # k, v differ
    assert tfa.takes_tma(q, k[:, :, :1], k[:, :, :1]) is False  # heads
    seg = torch.zeros(2, 8, dtype=torch.int32)
    assert tfa.takes_tma(q, k, k, seg=seg) is False
    with pytest.raises(ValueError, match="queries and keys alike"):
        tfa.flash_attention_fwd_reference(q.float(), k.float(), k.float(),
                                          seg=seg)
    # the launch checks: q may differ from k and v in L alone, at head
    # dim 64 or 128
    assert tfa._check("t", q, (q, k, k, q)) == (2, 8, 24, 2, 64)
    with pytest.raises(ValueError, match="head dim"):
        tfa._check("t", q[..., :32], (q[..., :32], k[..., :32],
                                      k[..., :32]))
    with pytest.raises(ValueError, match="beyond the sequence length"):
        tfa._check("t", q, (q, k, k[:, :5]))
    with pytest.raises(ValueError, match="queries and keys alike"):
        tfa._check("t", q, (q, k, k), seg=seg)
    # the operator's fake kernel gives out like q, lse [B, H, Lq]
    out, lse = tfa._flash_fwd_fake(q, k, k, False, None, 0.0, None, None,
                                   None)
    assert out.shape == q.shape and lse.shape == (2, 2, 8)


def test_multi_head_attention_cross_and_cache_match_jax():
    """MultiHeadAttention(query, memory) with 7 queries against 11 keys,
    then the same layer stepped with ``cache=``: each step equals the
    full call over the prefix (queries one at a time against every key
    so far), and the returned cache holds the concatenated keys."""
    jpaddle.seed(5)
    jm = jpaddle.nn.MultiHeadAttention(32, 4)
    tm = tpaddle.nn.MultiHeadAttention(32, 4, device="cpu")
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm.load_state_dict(state_dict_from_jax(arrays, model=tm))
    jm.eval()
    tm.eval()
    r = np.random.default_rng(9)
    x = r.standard_normal((2, 7, 32)).astype(np.float32)
    mem = r.standard_normal((2, 11, 32)).astype(np.float32)
    want = np.asarray(jm(jpaddle.to_tensor(x), jpaddle.to_tensor(mem))._data)
    got = tm(tpaddle.to_tensor(x), tpaddle.to_tensor(mem))
    _close(got.numpy(), want, FWD_TOL, "cross")
    # decode steps over a cache (self-attention of the prefix)
    full = [np.asarray(jm(jpaddle.to_tensor(x[:, :t + 1]))._data)[:, t]
            for t in range(7)]
    cache = (None, None)
    jcache = (None, None)
    for t in range(7):
        xt = x[:, t:t + 1]
        out, cache = tm(tpaddle.to_tensor(xt), cache=cache)
        jout, jcache = jm(jpaddle.to_tensor(xt), cache=jcache)
        assert cache[0].shape == [2, t + 1, 4, 8]
        _close(out.numpy()[:, 0], np.asarray(jout._data)[:, 0], FWD_TOL,
               f"step {t} vs jax")
        _close(out.numpy()[:, 0], full[t], FWD_TOL, f"step {t} vs full")
