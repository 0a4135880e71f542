"""The flash-attention wrappers' choice of design, on the CPU.

``takes_tma`` decides from the operands alone which calls the TMA /
wgmma kernels (``csrc/flash_attention_tma.cu``: bf16, head dim 64 or
128, no segments, dropout at head dim 64 only, bases and strides a TMA
tensor map describes) take; everything else goes to the first design.
On the CPU the three wrappers take their plain versions whatever the
design would be, and count nothing. The kernels themselves run in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card. No JAX
here.
"""
import pytest
import torch

from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn import transformer as ttr
from paddle_tpu_torch.nn.functional import attention as tattn
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


def _misaligned(seed=0, d=D):
    """A base two bytes past a 16-byte boundary."""
    flat = torch.empty(B * L * H * d + 1, dtype=torch.bfloat16)
    x = flat[1:].view(B, L, H, d)
    x.copy_(_bf16(B, L, H, d, seed=seed))
    return x


def _captured(module, name, monkeypatch, call):
    """The q, k, v a model's attention hands its flash entry
    (``module.name``), captured on the CPU by a stand-in that returns
    zeros."""
    seen = []

    def grab(q, k, v, *args, **kwargs):
        seen.append((q, k, v))
        return torch.zeros_like(q)

    monkeypatch.setattr(module, name, grab)
    with torch.no_grad():
        call()
    return list(seen[0])


def _bert_views(monkeypatch):
    """MultiHeadAttention at BERT-base widths (hidden 768, 12 heads of
    64): separate q, k, v projections viewed as [B, L, 12, 64]."""
    mha = ttr.MultiHeadAttention(768, 12, dropout=0.1, dtype=torch.bfloat16)
    x = _bf16(B, L, 768)
    return _captured(tattn, "_flash", monkeypatch, lambda: mha(x))


def _gpt_views(monkeypatch):
    """GPTAttention at ERNIE-MoE widths (hidden 768, 12 heads of 64):
    one qkv projection split into three views of row stride 2304, k and
    v starting 1536 and 3072 bytes in."""
    attn = tgpt.GPTAttention(tgpt.GPTConfig(hidden_size=768,
                                            num_attention_heads=12,
                                            use_flash_attention=True),
                             dtype=torch.bfloat16)
    x = _bf16(B, L, 768)
    return _captured(tgpt, "flash_attention", monkeypatch, lambda: attn(x))


ACCEPTED = {
    "blhd": (lambda: _three(lambda seed: _bf16(B, L, H, D, seed=seed)), {}),
    "bhld_3d": (lambda: _three(lambda seed: _bf16(B * H, L, D, seed=seed)),
                {}),
    "strided_qkv": (lambda: _strided_qkv(), {}),
    "heads_outer": (lambda: _three(
        lambda seed: _bf16(B, H, L, D, seed=seed).transpose(1, 2)), {}),
    "one_row": (lambda: _three(lambda seed: _bf16(B, 1, H, D, seed=seed)),
                {}),
    # head dim 64 (BERT-base, ERNIE-MoE), with dropout and without
    "d64": (lambda: _three(lambda seed: _bf16(B, L, H, 64, seed=seed)), {}),
    "d64_dropout": (lambda: _three(lambda seed: _bf16(B, L, H, 64,
                                                      seed=seed)),
                    {"dropout_p": 0.1}),
    "d64_bhld_3d": (lambda: _three(lambda seed: _bf16(B * H, L, 64,
                                                      seed=seed)), {}),
    "d64_bhld_3d_dropout": (lambda: _three(
        lambda seed: _bf16(B * H, L, 64, seed=seed)), {"dropout_p": 0.1}),
    "d64_one_row_dropout": (lambda: _three(
        lambda seed: _bf16(B, 1, H, 64, seed=seed)), {"dropout_p": 0.1}),
}

# the views the models build, captured with pytest's monkeypatch
MODEL_VIEWS = {"bert_mha": _bert_views, "ernie_moe_gpt": _gpt_views}

REFUSED = {
    "f32": (lambda: _three(lambda seed: _bf16(B, L, H, D, seed=seed).float()),
            {}),
    "dropout": (lambda: _three(lambda seed: _bf16(B, L, H, D, seed=seed)),
                {"dropout_p": 0.1}),
    "d32": (lambda: _three(lambda seed: _bf16(B, L, H, 32, seed=seed)), {}),
    "d64_f32_dropout": (lambda: _three(
        lambda seed: _bf16(B, L, H, 64, seed=seed).float()),
        {"dropout_p": 0.1}),
    "d64_segments": (lambda: _three(lambda seed: _bf16(B, L, H, 64,
                                                       seed=seed)),
                     {"seg": torch.zeros(B, L, dtype=torch.int32)}),
    "d64_misaligned_base": (lambda: [_misaligned(0, 64)] + _three(
        lambda seed: _bf16(B, L, H, 64, seed=seed))[1:], {}),
    "d64_stride_not_16_bytes": (lambda: _three(
        lambda seed: _bf16(B, L, H, 68, seed=seed)[..., :64]), {}),
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
    make, kw = ACCEPTED[name]
    q, k, v = make()
    assert tfa.takes_tma(q, k, v, **kw) is True
    # the backward's call: dO beside them
    assert tfa.takes_tma(q, k, v, torch.zeros_like(q), **kw) is True


@pytest.mark.parametrize("dropout_p", [0.0, 0.1], ids=["p0", "p01"])
@pytest.mark.parametrize("model", sorted(MODEL_VIEWS))
def test_takes_tma_accepts_the_views_the_models_build(model, dropout_p,
                                                      monkeypatch):
    """The exact q, k, v of BERT-base's MultiHeadAttention and ERNIE-MoE's
    GPTAttention go to the TMA kernels, with dropout and without."""
    q, k, v = MODEL_VIEWS[model](monkeypatch)
    assert q.shape == (B, L, 12, 64) and q.dtype == torch.bfloat16
    if model == "ernie_moe_gpt":       # views of one [B, L, 2304] output
        assert q.stride() == (L * 2304, 2304, 64, 1)
        assert k.data_ptr() - q.data_ptr() == 1536
        assert v.data_ptr() - q.data_ptr() == 3072
    do = torch.zeros_like(q)
    assert tfa.takes_tma(q, k, v, do, dropout_p=dropout_p) is True


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_takes_tma_refuses_what_the_first_design_keeps(name):
    make, kw = REFUSED[name]
    q, k, v = make()
    assert tfa.takes_tma(q, k, v, **kw) is False


@pytest.mark.parametrize("which", ["misaligned", "f32", "other_shape"])
def test_takes_tma_checks_the_backward_dout(which):
    """The backward's dO must meet the same conditions as q, k, v."""
    q, k, v = ACCEPTED["blhd"][0]()
    do = {"misaligned": _misaligned,
          "f32": lambda: torch.zeros(B, L, H, D),
          "other_shape": lambda: torch.zeros(B, L + 1, H, D,
                                             dtype=torch.bfloat16)}[which]()
    assert tfa.takes_tma(q, k, v) is True
    assert tfa.takes_tma(q, k, v, do) is False


@pytest.mark.parametrize("layout", ["blhd", "strided_qkv", "d64",
                                    "d64_dropout"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cpu_tensors_take_the_plain_versions_and_count_nothing(layout,
                                                               causal):
    """Calls the TMA kernels would take on the card run the plain versions
    here, bit for bit, and no count moves."""
    make, drop = ACCEPTED[layout]
    q, k, v = make()
    kw = dict(drop, seed=0x5EED) if drop else {}
    do = _bf16(*q.shape, seed=9)
    assert tfa.takes_tma(q, k, v, do, **drop)
    ws = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
          tfa.flash_attention_bwd_dkv)
    counts = ("launches", "tma_launches", "dropout_launches")
    before = [[getattr(w, c) for c in counts] for w in ws]
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, **kw)
    delta = tfa.attention_delta(out, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, **kw)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                         **kw)
    assert [[getattr(w, c) for c in counts] for w in ws] == before
    ref_out, ref_lse = tfa.flash_attention_fwd_reference(q, k, v, causal,
                                                         **kw)
    ref_dq = tfa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                  causal, **kw)
    ref_dk, ref_dv = tfa.flash_attention_bwd_dkv_reference(
        q, k, v, do, lse, delta, causal, **kw)
    for got, ref in ((out, ref_out), (lse, ref_lse), (dq, ref_dq),
                     (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
