"""The port's beam search (``nn.decode``) against the JAX package's, on
the CPU.

A ``BeamSearchDecoder`` over an ``LSTMCell`` with an ``Embedding`` as
``embedding_fn`` and a ``Linear`` as ``output_fn`` (the JAX parameters
loaded by name), run by ``dynamic_decode``: the predicted ids equal, the
final beam scores within 1e-5·(1 + |ref|), the lengths equal, batch- and
time-major, with ``return_length``; a decode whose beams all end stops
early on both sides.
"""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.convert import load_layer_from_jax
from test_torch_tensor import port_on_cpu  # noqa: F401

TOL = 1e-5
V, H, BATCH = 12, 8, 3


def _twin(jlayer, tlayer):
    load_layer_from_jax(tlayer, {n: np.asarray(p._data)
                                 for n, p in jlayer.named_parameters()})
    return tlayer


def _parts(seed, end_bias=0.0):
    jpaddle.seed(seed)
    jcell = jpaddle.nn.LSTMCell(H, H)
    jemb = jpaddle.nn.Embedding(V, H)
    jproj = jpaddle.nn.Linear(H, V)
    if end_bias:
        b = np.asarray(jproj.bias._data).copy()
        b[1] += end_bias
        jproj.bias.set_value(b)
    return ((jcell, jemb, jproj),
            (_twin(jcell, tpaddle.nn.LSTMCell(H, H)),
             _twin(jemb, tpaddle.nn.Embedding(V, H)),
             _twin(jproj, tpaddle.nn.Linear(H, V))))


def _decode(P, parts, beam, max_step, time_major):
    cell, emb, proj = parts
    dec = P.nn.BeamSearchDecoder(cell, 0, 1, beam, embedding_fn=emb,
                                 output_fn=proj)
    ref = P.to_tensor(np.zeros((BATCH, H), np.float32))
    inits = cell.get_initial_states(ref)
    return P.nn.dynamic_decode(dec, inits, max_step_num=max_step,
                               output_time_major=time_major,
                               return_length=True)


def _np(v):
    return np.asarray(v._data) if isinstance(v, jpaddle.Tensor) else \
        v.numpy() if isinstance(v, tpaddle.Tensor) else np.asarray(v)


@pytest.mark.parametrize("time_major", [False, True],
                         ids=["batch_major", "time_major"])
@pytest.mark.parametrize("beam,max_step,seed,end_bias",
                         [(4, 6, 0, 0.0), (3, 9, 1, 0.0), (2, 20, 2, 3.0)],
                         ids=["beam4", "beam3", "ends_early"])
def test_beam_search_matches_jax(beam, max_step, seed, end_bias,
                                 time_major):
    jparts, tparts = _parts(seed, end_bias)
    jids, jst, jlen = _decode(jpaddle, jparts, beam, max_step, time_major)
    tids, tst, tlen = _decode(tpaddle, tparts, beam, max_step, time_major)
    np.testing.assert_array_equal(_np(tids), _np(jids))
    want = np.asarray(jst.log_probs, np.float64)
    got = tst.log_probs.numpy().astype(np.float64)
    assert np.all(np.abs(got - want) <= TOL * (1 + np.abs(want)))
    np.testing.assert_array_equal(_np(tlen), _np(jlen))
    np.testing.assert_array_equal(tst.finished.numpy(),
                                  np.asarray(jst.finished))
    steps = _np(tids).shape[0 if time_major else 1]
    if end_bias:
        assert steps < max_step + 1      # every beam ended first
    assert _np(tids).shape[2] == beam


def test_tile_beam_merge_with_batch():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = tpaddle.nn.BeamSearchDecoder.tile_beam_merge_with_batch(
        tpaddle.to_tensor(x), 2)
    want = jpaddle.nn.BeamSearchDecoder.tile_beam_merge_with_batch(
        jpaddle.to_tensor(x), 2)
    np.testing.assert_array_equal(_np(got), _np(want))
