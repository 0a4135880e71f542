"""The port's BERT MLM slice against the JAX package's, on the CPU.

The same weights (copied with ``convert``, which finds the Linear
weights from the port model's own modules) and the same ids go through
the JAX ``BertForMaskedLM`` and the port's: logits of a tiny model
without dropout (the JAX side takes its XLA sdpa on the CPU, the port
its plain flash walk), then three AdamW ``TrainStep``s with
``CrossEntropyLoss`` on 3-D logits, as ``bench.py``'s BERT workload
steps. Tolerances are the training slice's f32 ones
(``tests/test_torch_train.py``): the two frameworks sum in other
orders. With dropout the two draw different random numbers, so the
port is held to itself: one seed, one loss; train and eval differ.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import BertForMaskedLM as JaxBert
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import (linear_weight_names, load_from_jax,
                                      state_dict_from_jax)
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.optimizer import AdamW

LR, STEPS = 1e-4, 3
# the training slice's tolerances (tests/test_torch_train.py)
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
PARAM_CLOSE, PARAM_CLOSE_SHARE = 1e-5, 0.99


def _arrays(jm):
    return {n: np.asarray(p._data) for n, p in jm.named_parameters()}


def _port_layout(tm, name, a):
    a = np.asarray(a)
    return a.T if name in linear_weight_names(tm) else a


def _ids():
    return np.random.default_rng(0).integers(0, 128, (2, 24)).astype(
        np.int32)


def _pair(dropout=0.0, seed=13):
    paddle.seed(seed)
    jm = JaxBert(JaxBertConfig.tiny(dropout=dropout))
    tm = BertForMaskedLM(BertConfig.tiny(dropout=dropout), device="cpu")
    load_from_jax(tm, _arrays(jm))
    return jm, tm


def test_tiny_bert_logits_match_jax():
    jm, tm = _pair()
    ids = _ids()
    jm.eval()
    tm.eval()
    want = np.asarray(jm(paddle.to_tensor(ids))._data)
    got = tm(torch.from_numpy(ids).long())
    assert got.shape == (2, 24, 128)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)


@pytest.fixture(scope="module")
def trained():
    jm, tm = _pair()
    ids = _ids()
    tids = torch.from_numpy(ids).long()
    jcrit, tcrit = paddle.nn.CrossEntropyLoss(), CrossEntropyLoss()
    # first-step gradients, eager on both sides
    jloss0 = jcrit(jm(paddle.to_tensor(ids)), paddle.to_tensor(ids))
    jloss0.backward()
    jgrads = {n: (np.asarray(p.grad._data) if p.grad is not None else None)
              for n, p in jm.named_parameters()}
    for p in jm.parameters():
        p.clear_gradient()
    tloss0 = tcrit(tm(tids), tids)
    tloss0.backward()
    tgrads = {n: p.grad for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters(),
                                  multi_precision=False)
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jopt)
    topt = AdamW(learning_rate=LR, parameters=tm.named_parameters(),
                 multi_precision=False)
    tstep = TrainStep(tm, tcrit, topt)
    jl, tl = [], []
    for _ in range(STEPS):
        jl.append(float(jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))))
        tl.append(tstep(tids, tids).item())
    return dict(jm=jm, tm=tm, jloss0=float(jloss0), tloss0=tloss0.item(),
                jgrads=jgrads, tgrads=tgrads, jl=jl, tl=tl)


def test_train_steps_track_jax_losses(trained):
    t = trained
    np.testing.assert_allclose(t["tloss0"], t["jloss0"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(t["tl"], t["jl"], rtol=LOSS_RTOL)
    assert t["jl"][-1] < t["jl"][0]


def test_first_step_gradients_match_jax(trained):
    """Every gradient the loss reaches; the parameters it does not reach
    (token-type embeddings, the pooler) have none on either side."""
    t = trained
    assert set(t["tgrads"]) == set(t["jgrads"])
    for name, g in t["tgrads"].items():
        ref = t["jgrads"][name]
        if g is None or ref is None:
            assert (g is None or not g.any()) and \
                (ref is None or not ref.any()), name
            continue
        ref = _port_layout(t["tm"], name, ref)
        err = np.abs(g.numpy() - ref)
        assert (err <= GRAD_ATOL + GRAD_RTOL * np.abs(ref)).all(), \
            (name, float(err.max()))


def test_parameters_after_three_steps_match_jax(trained):
    """AdamW turns a sign flip of a near-zero gradient into a whole lr
    step, so: 99 % of the elements within 1e-5, all within
    3 * lr * steps. The parameters the loss does not reach only decay,
    on both sides (the port's TrainStep gives them zero gradients, as
    the JAX step differentiates the whole tree)."""
    t = trained
    tparams = dict(t["tm"].named_parameters())
    n_close = n_all = 0
    for name, p in t["jm"].named_parameters():
        ref = _port_layout(t["tm"], name, p._data)
        err = np.abs(tparams[name].detach().numpy() - ref)
        assert err.max() <= 3 * LR * STEPS, (name, float(err.max()))
        n_close += int((err <= PARAM_CLOSE).sum())
        n_all += err.size
    assert n_close >= PARAM_CLOSE_SHARE * n_all, n_close / n_all


def test_dropout_is_seeded_by_the_port_generator_and_train_only():
    """BERT's own dropout (0.1): around the layers (the hash mask) and
    inside attention (the kernels' Philox mask). One port seed gives one
    loss; another seed and eval mode give others; nothing is NaN."""
    _, tm = _pair(dropout=0.1)
    tids = torch.from_numpy(_ids()).long()
    crit = CrossEntropyLoss()
    tm.train()
    losses = []
    for s in (4, 4, 5):
        trandom.seed(s)
        losses.append(crit(tm(tids), tids).item())
    assert losses[0] == losses[1] and losses[0] != losses[2]
    tm.eval()
    ev = crit(tm(tids), tids).item()
    assert ev != losses[0]
    assert all(np.isfinite(losses + [ev]))
    step = TrainStep(tm, crit, AdamW(learning_rate=LR,
                                     parameters=tm.named_parameters()))
    assert np.isfinite(step(tids, tids).item()) and tm.training


def test_convert_round_trips_bert_and_llama_state_dicts():
    """JAX parameters -> the port's state dict -> back: every array
    equal. The Linear weights are found from the port model's modules
    (BERT's out_proj, linear1/2, pooler, transform and decoder among
    them); for Llama that agrees with the default name list."""
    paddle.seed(3)
    cases = [(JaxBert(JaxBertConfig.tiny()),
              BertForMaskedLM(BertConfig.tiny(), device="cpu")),
             (JaxLlama(JaxLlamaConfig.tiny()),
              LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"))]
    for jm, tm in cases:
        arrays = _arrays(jm)
        load_from_jax(tm, arrays)
        lin = linear_weight_names(tm)
        assert lin and all(arrays[n].ndim == 2 for n in lin)
        back = {n: (p.detach().numpy().T if n in lin else
                    p.detach().numpy())
                for n, p in tm.state_dict().items()}
        assert set(back) == set(arrays)
        for n, a in arrays.items():
            np.testing.assert_array_equal(back[n], a)
    bert_lin = linear_weight_names(cases[0][1])
    assert {"bert.pooler.weight", "transform.weight", "decoder.weight",
            "bert.encoder.layers.0.self_attn.out_proj.weight",
            "bert.encoder.layers.1.linear2.weight"} <= bert_lin
    llama_arrays = _arrays(cases[1][0])
    by_model = state_dict_from_jax(llama_arrays, cases[1][1])
    by_name = state_dict_from_jax(llama_arrays)
    for n in llama_arrays:
        assert torch.equal(by_model[n], by_name[n])
