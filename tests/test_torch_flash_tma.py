"""The flash-attention wrappers' choice of design, on the CPU.

``takes_tma`` decides from the operands alone which calls the TMA /
wgmma kernels (``csrc/flash_attention_tma.cu``: bf16, head dim 128, no
dropout, no segments, bases and strides a TMA tensor map describes)
take; everything else goes to the first design. On the CPU the three
wrappers take their plain versions whatever the design would be, and
count nothing. The kernels themselves run in ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` on the card. No JAX here.
"""
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as tfa

B, L, H, D = 2, 40, 3, 128


def _bf16(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).bfloat16()


def _three(make):
    return [make(seed=i) for i in range(3)]


def _strided_qkv(seed=0):
    """q, k, v as views of one [B, L, 3, H, D] projection."""
    return list(_bf16(B, L, 3, H, D, seed=seed).unbind(2))


def _misaligned(seed=0):
    """A base two bytes past a 16-byte boundary."""
    flat = torch.empty(B * L * H * D + 1, dtype=torch.bfloat16)
    x = flat[1:].view(B, L, H, D)
    x.copy_(_bf16(B, L, H, D, seed=seed))
    return x


ACCEPTED = {
    "blhd": lambda: _three(lambda seed: _bf16(B, L, H, D, seed=seed)),
    "bhld_3d": lambda: _three(lambda seed: _bf16(B * H, L, D, seed=seed)),
    "strided_qkv": lambda: _strided_qkv(),
    "heads_outer": lambda: _three(
        lambda seed: _bf16(B, H, L, D, seed=seed).transpose(1, 2)),
    "one_row": lambda: _three(lambda seed: _bf16(B, 1, H, D, seed=seed)),
}

REFUSED = {
    "f32": (lambda: _three(lambda seed: _bf16(B, L, H, D, seed=seed).float()),
            {}),
    "d64": (lambda: _three(lambda seed: _bf16(B, L, H, 64, seed=seed)), {}),
    "dropout": (lambda: _three(lambda seed: _bf16(B, L, H, D, seed=seed)),
                {"dropout_p": 0.1}),
    "segments": (lambda: _three(lambda seed: _bf16(B, L, H, D, seed=seed)),
                 {"seg": torch.zeros(B, L, dtype=torch.int32)}),
    "head_dim_not_contiguous": (lambda: _three(
        lambda seed: _bf16(B, L, H, 2 * D, seed=seed)[..., ::2]), {}),
    "misaligned_base": (lambda: [_misaligned(0)] + _three(
        lambda seed: _bf16(B, L, H, D, seed=seed))[1:], {}),
    "stride_not_16_bytes": (lambda: _three(
        lambda seed: _bf16(B, L, H, D + 4, seed=seed)[..., :D]), {}),
    "shapes_differ": (lambda: [_bf16(B, L, H, D), _bf16(B, L + 1, H, D),
                               _bf16(B, L + 1, H, D)], {}),
    "empty": (lambda: _three(lambda seed: _bf16(B, 0, H, D, seed=seed)), {}),
}


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_takes_tma_accepts_what_a_tensor_map_describes(name):
    q, k, v = ACCEPTED[name]()
    assert tfa.takes_tma(q, k, v) is True
    # the backward's call: dO beside them
    assert tfa.takes_tma(q, k, v, torch.zeros_like(q)) is True


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_takes_tma_refuses_what_the_first_design_keeps(name):
    make, kw = REFUSED[name]
    q, k, v = make()
    assert tfa.takes_tma(q, k, v, **kw) is False


@pytest.mark.parametrize("which", ["misaligned", "f32", "other_shape"])
def test_takes_tma_checks_the_backward_dout(which):
    """The backward's dO must meet the same conditions as q, k, v."""
    q, k, v = ACCEPTED["blhd"]()
    do = {"misaligned": _misaligned,
          "f32": lambda: torch.zeros(B, L, H, D),
          "other_shape": lambda: torch.zeros(B, L + 1, H, D,
                                             dtype=torch.bfloat16)}[which]()
    assert tfa.takes_tma(q, k, v) is True
    assert tfa.takes_tma(q, k, v, do) is False


@pytest.mark.parametrize("layout", ["blhd", "strided_qkv"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cpu_tensors_take_the_plain_versions_and_count_nothing(layout,
                                                               causal):
    """Calls the TMA kernels would take on the card run the plain versions
    here, bit for bit, and no count moves."""
    q, k, v = ACCEPTED[layout]()
    do = _bf16(B, L, H, D, seed=9)
    assert tfa.takes_tma(q, k, v, do)
    ws = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
          tfa.flash_attention_bwd_dkv)
    before = [(w.launches, w.tma_launches) for w in ws]
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    delta = tfa.attention_delta(out, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    assert [(w.launches, w.tma_launches) for w in ws] == before
    ref_out, ref_lse = tfa.flash_attention_fwd_reference(q, k, v, causal)
    ref_dq = tfa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                  causal)
    ref_dk, ref_dv = tfa.flash_attention_bwd_dkv_reference(
        q, k, v, do, lse, delta, causal)
    for got, ref in ((out, ref_out), (lse, ref_lse), (dq, ref_dq),
                     (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
