"""The port's recurrent layers (``nn.rnn``) against the JAX package's, on
the CPU.

Every cell one step (with and without states), the multi-layer layers
(2 layers, forward and bidirect, batch- and time-major, with initial
states) and the ``RNN`` / ``BiRNN`` wrappers, the JAX parameters loaded
by name with ``convert.load_layer_from_jax`` (nothing transposed): within
1e-5·(1 + |ref|). The JAX layers take ``sequence_length`` and ignore it;
the port freezes each sequence's state after its length and zeroes its
outputs there, so with lengths the port is held to the JAX layer run on
each sequence cut to its length: the outputs inside the length, zeros
after, the final states. The port's time loop is torch ops on the
device; the JAX one a ``lax.scan``.
"""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.convert import load_layer_from_jax
from test_torch_tensor import port_on_cpu  # noqa: F401

TOL = 1e-5
_R = np.random.default_rng(4)


def _f(*shape):
    return _R.standard_normal(shape).astype(np.float32)


def _np(v):
    if isinstance(v, jpaddle.Tensor):
        return np.asarray(v._data)
    if isinstance(v, tpaddle.Tensor):
        return v.numpy()
    return np.asarray(v)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) - TOL * (1 + np.abs(want))
    assert err.max() <= 0, (what, float(np.abs(got - want).max()))


def _tree_close(got, want, what):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _tree_close(g, w, f"{what}[{i}]")
        return
    _close(_np(got), _np(want), what)


def _twin(jlayer, tlayer):
    load_layer_from_jax(tlayer, {n: np.asarray(p._data)
                                 for n, p in jlayer.named_parameters()})
    return tlayer


CELLS = {
    "simple_tanh": lambda P: P.nn.SimpleRNNCell(5, 7),
    "simple_relu": lambda P: P.nn.SimpleRNNCell(5, 7, activation="relu"),
    "lstm": lambda P: P.nn.LSTMCell(5, 7),
    "gru": lambda P: P.nn.GRUCell(5, 7),
}


@pytest.mark.parametrize("with_states", [False, True],
                         ids=["zero_states", "states"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cells_match_jax(cell, with_states):
    jpaddle.seed(1)
    jc = CELLS[cell](jpaddle)
    tc = _twin(jc, CELLS[cell](tpaddle))
    x = _f(3, 5)
    states = None
    if with_states:
        states = (_f(3, 7), _f(3, 7)) if cell == "lstm" else _f(3, 7)
    js = None if states is None else jpaddle.nn.decode._map_structure(
        jpaddle.to_tensor, states)
    ts = None if states is None else jpaddle.nn.decode._map_structure(
        tpaddle.to_tensor, states)
    jo, jst = jc(jpaddle.to_tensor(x), js)
    to, tst = tc(tpaddle.to_tensor(x), ts)
    _close(_np(to), _np(jo), "out")
    _tree_close(tst, jst, "states")
    assert tc.state_shape == jc.state_shape
    init = tc.get_initial_states(tpaddle.to_tensor(x))
    _tree_close(init, jc.get_initial_states(jpaddle.to_tensor(x)), "init")


LAYERS = ("SimpleRNN", "LSTM", "GRU")


def _states(cls, nd, batch):
    h = _f(2 * nd, batch, 6)
    return (h, _f(2 * nd, batch, 6)) if cls == "LSTM" else h


@pytest.mark.parametrize("time_major", [False, True],
                         ids=["batch_major", "time_major"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("cls", LAYERS)
def test_layers_match_jax(cls, direction, time_major):
    jpaddle.seed(2)
    kw = dict(num_layers=2, direction=direction, time_major=time_major)
    jl = getattr(jpaddle.nn, cls)(4, 6, **kw)
    tl = _twin(jl, getattr(tpaddle.nn, cls)(4, 6, **kw))
    names = sorted(n for n, _ in jl.named_parameters())
    assert names == sorted(n for n, _ in tl.named_parameters())
    x = _f(5, 3, 4) if time_major else _f(3, 5, 4)
    nd = 2 if direction == "bidirect" else 1
    for states in (None, _states(cls, nd, 3)):
        js = None if states is None else jpaddle.nn.decode._map_structure(
            jpaddle.to_tensor, states)
        ts = None if states is None else jpaddle.nn.decode._map_structure(
            tpaddle.to_tensor, states)
        jo, jst = jl(jpaddle.to_tensor(x), js)
        to, tst = tl(tpaddle.to_tensor(x), ts)
        _close(_np(to), _np(jo), "outputs")
        _tree_close(tst, jst, "final states")


@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("cls", LAYERS)
def test_sequence_length_equals_each_sequence_cut_to_its_length(cls,
                                                                direction):
    jpaddle.seed(3)
    kw = dict(num_layers=2, direction=direction)
    jl = getattr(jpaddle.nn, cls)(4, 6, **kw)
    tl = _twin(jl, getattr(tpaddle.nn, cls)(4, 6, **kw))
    x = _f(3, 5, 4)
    lens = np.array([5, 2, 4])
    to, tst = tl(tpaddle.to_tensor(x),
                 sequence_length=tpaddle.to_tensor(lens))
    to = _np(to)
    for b, n in enumerate(lens):
        jo, jst = jl(jpaddle.to_tensor(x[b:b + 1, :n]))
        _close(to[b:b + 1, :n], _np(jo), f"outputs of sequence {b}")
        assert np.abs(to[b, n:]).max(initial=0.0) == 0.0
        if cls == "LSTM":
            for i in range(2):
                _close(_np(tst[i])[:, b:b + 1], _np(jst[i]), f"state {i}")
        else:
            _close(_np(tst)[:, b:b + 1], _np(jst), "state")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_and_birnn_wrappers_match_jax(cell):
    jpaddle.seed(5)
    jf, jb = CELLS[cell](jpaddle), CELLS[cell](jpaddle)
    tf, tb = _twin(jf, CELLS[cell](tpaddle)), _twin(jb, CELLS[cell](tpaddle))
    x = _f(2, 4, 5)
    for time_major in (False, True):
        xi = x.transpose(1, 0, 2).copy() if time_major else x
        jo, jst = jpaddle.nn.RNN(jf, is_reverse=True,
                                 time_major=time_major)(
            jpaddle.to_tensor(xi))
        to, tst = tpaddle.nn.RNN(tf, is_reverse=True,
                                 time_major=time_major)(
            tpaddle.to_tensor(xi))
        _close(_np(to), _np(jo), "rnn outputs")
        _tree_close(tst, jst, "rnn states")
    jo, jst = jpaddle.nn.BiRNN(jf, jb)(jpaddle.to_tensor(x))
    to, tst = tpaddle.nn.BiRNN(tf, tb)(tpaddle.to_tensor(x))
    _close(_np(to), _np(jo), "birnn outputs")
    _tree_close(tst, jst, "birnn states")
    # sequence lengths: each sequence cut to its length
    lens = np.array([4, 1])
    to, tst = tpaddle.nn.BiRNN(tf, tb)(tpaddle.to_tensor(x),
                                       sequence_length=tpaddle.to_tensor(
                                           lens))
    for b, n in enumerate(lens):
        jo, jst = jpaddle.nn.BiRNN(jf, jb)(jpaddle.to_tensor(x[b:b + 1, :n]))
        _close(_np(to)[b:b + 1, :n], _np(jo), f"birnn sequence {b}")
        assert np.abs(_np(to)[b, n:]).max(initial=0.0) == 0.0


def test_dropout_between_layers_in_training_only():
    """The port drops the outputs of every layer but the last in training
    (paddle's semantics; the JAX layers keep the argument unused)."""
    tpaddle.seed(0)
    lstm = tpaddle.nn.LSTM(4, 6, num_layers=2, dropout=0.5)
    x = tpaddle.to_tensor(_f(2, 3, 4))
    lstm.eval()
    a, _ = lstm(x)
    b, _ = lstm(x)
    np.testing.assert_array_equal(_np(a), _np(b))
    lstm.train()
    c, _ = lstm(x)
    assert np.abs(_np(c) - _np(a)).max() > 0
    one = tpaddle.nn.LSTM(4, 6, num_layers=1, dropout=0.5)
    one.train()
    d, _ = one(x)
    one.eval()
    np.testing.assert_array_equal(_np(d), _np(one(x)[0]))
