"""Recurrent layers of the port (``paddle_tpu/nn/rnn.py``): the cells
``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell`` over ``RNNCellBase``, the
multi-layer ``SimpleRNN``, ``LSTM`` and ``GRU``, and the ``RNN`` /
``BiRNN`` wrappers of a cell.

The JAX package's gate order (LSTM ``i, f, g, o``; GRU ``r, z, c`` with
the reset gate on the hidden projection), parameter names
(``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh``; per layer and
direction ``weight_ih_l{k}[_reverse]`` ...), shapes (``[gates · hidden,
in]``, used as ``x Wᵀ``) and initializer (uniform in ±1/√hidden) are
kept, so a JAX ``state_dict()`` loads as it is. The JAX time loop is a
``lax.scan``; here it is a loop of plain torch ops on the device: the
input projection of every step is one product ahead of the loop, then a
step is one product with ``weight_hh`` and the gates. No step reads the
host, so a CUDA graph captures the loop whole. cuDNN's RNN (a library
kernel with its own weight layout) is not used.

``sequence_length`` (``[B]`` ints) freezes each sequence's state after
its length and zeroes its outputs there (the reverse direction starts at
its last valid step), as paddle does; the JAX layers take it and ignore
it. ``dropout`` drops the outputs of every layer but the last in
training, as paddle does; the JAX layers keep it and never apply it.
The layers are Layers (:class:`~.layer.Layer`) whose ``forward`` is
written against torch tensors (``_torch_forward``): Tensors in, Tensors
out.
"""
from __future__ import annotations

import math

import torch

from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell",
           "SimpleRNN", "LSTM", "GRU", "RNN", "BiRNN"]


def _uniform_init(hidden_size):
    k = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-k, k)


def _map(fn, *structs):
    s0 = structs[0]
    if isinstance(s0, (list, tuple)):
        return type(s0)(_map(fn, *xs) for xs in zip(*structs))
    return fn(*structs)


def _act(name: str):
    return torch.tanh if name == "tanh" else torch.relu


# one step of each cell from its input projection xw = x Wihᵀ + bih
def _simple_step(act):
    def step(xw, h, wh, bh):
        return act(xw + h @ wh.t() + bh)
    return step


def _lstm_step(xw, carry, wh, bh):
    h, c = carry
    gates = xw + h @ wh.t() + bh
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_step(xw, h, wh, bh):
    gh = h @ wh.t() + bh
    ir, iz, ic = xw.chunk(3, dim=-1)
    hr, hz, hc = gh.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    c = torch.tanh(ic + r * hc)
    return (1 - z) * c + z * h


class RNNCellBase(Layer):
    """Base class of the cells: ``get_initial_states`` over possibly
    nested state shapes."""
    _torch_forward = True

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States filled with ``init_value``, ``[batch] + shape`` each
        (``shape`` defaults to ``state_shape``), f32 unless ``dtype``,
        on ``batch_ref``'s device; Tensors for a Tensor reference."""
        from ..core.dtype import convert_dtype
        from ..core.tensor import Tensor
        wrapped = isinstance(batch_ref, Tensor)
        ref = batch_ref._t if wrapped else batch_ref
        batch = ref.shape[batch_dim_idx]
        dt = convert_dtype(dtype) if dtype is not None else torch.float32
        shape = self.state_shape if shape is None else shape

        def build(s):
            if isinstance(s, (list, tuple)) and s and \
                    isinstance(s[0], (list, tuple)):
                return type(s)(build(x) for x in s)
            t = torch.full([batch] + [int(d) for d in s], init_value,
                           dtype=dt, device=ref.device)
            return Tensor(t) if wrapped else t

        return build(shape)

    @property
    def state_shape(self):
        if hasattr(self, "hidden_size"):
            return [self.hidden_size]
        raise NotImplementedError(
            "cells must define state_shape or hidden_size")

    def _make(self, gates, input_size, hidden_size, attrs):
        """The four parameters of a cell with ``gates`` gates."""
        init = _uniform_init(hidden_size)
        wi, wh, bi, bh = attrs
        g = gates * hidden_size
        self.weight_ih = self.create_parameter(
            [g, input_size], attr=wi, default_initializer=init)
        self.weight_hh = self.create_parameter(
            [g, hidden_size], attr=wh, default_initializer=init)
        self.bias_ih = self.create_parameter(
            [g], attr=bi, is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [g], attr=bh, is_bias=True, default_initializer=init)

    def _zeros(self, inputs):
        return inputs.new_zeros((inputs.shape[0], self.hidden_size))

    def _xw(self, inputs):
        return inputs @ self.weight_ih.t() + self.bias_ih


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        self._make(1, input_size, hidden_size, (weight_ih_attr,
                                                weight_hh_attr,
                                                bias_ih_attr, bias_hh_attr))

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        h = _simple_step(_act(self.activation))(
            self._xw(inputs), h, self.weight_hh, self.bias_hh)
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._make(4, input_size, hidden_size, (weight_ih_attr,
                                                weight_hh_attr,
                                                bias_ih_attr, bias_hh_attr))

    @property
    def state_shape(self):
        return ([self.hidden_size], [self.hidden_size])

    def forward(self, inputs, states=None):
        if states is None:
            states = (self._zeros(inputs), self._zeros(inputs))
        h, c = _lstm_step(self._xw(inputs), tuple(states), self.weight_hh,
                          self.bias_hh)
        return h, (h, c)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._make(3, input_size, hidden_size, (weight_ih_attr,
                                                weight_hh_attr,
                                                bias_ih_attr, bias_hh_attr))

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        h = _gru_step(self._xw(inputs), h, self.weight_hh, self.bias_hh)
        return h, h


def _valid(sequence_length, T: int, device):
    """``[T, B, 1]`` bool: step t of sequence b is inside its length."""
    if sequence_length is None:
        return None
    lens = torch.as_tensor(sequence_length, device=device).reshape(1, -1, 1)
    return torch.arange(T, device=device).reshape(-1, 1, 1) < lens


def _scan(step, xw, carry, wh, bh, valid, reverse: bool):
    """Run ``step`` over the time-major projections ``xw [T, B, G]`` from
    ``carry`` (one state or a pair), backwards when ``reverse``; steps
    outside a sequence's length keep its state and output zeros. ->
    (outputs ``[T, B, hidden]``, last carry)."""
    T = xw.shape[0]
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        new = step(xw[t], carry, wh, bh)
        h = new[0] if isinstance(new, tuple) else new
        if valid is not None:
            m = valid[t]
            new = _map(lambda a, b: torch.where(m, a, b), new, carry)
            h = torch.where(m, h, torch.zeros_like(h))
        outs[t] = h
        carry = new
    return torch.stack(outs), carry


class _RNNBase(Layer):
    MODE = "RNN_TANH"
    GATES = 1
    _torch_forward = True

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"direction must be forward, bidirect or "
                             f"bidirectional, got {direction!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirect = direction in ("bidirect", "bidirectional")
        ndir = 2 if self.bidirect else 1
        self.num_directions = ndir
        init = _uniform_init(hidden_size)
        g = self.GATES * hidden_size
        for l in range(num_layers):
            for d in range(ndir):
                in_sz = input_size if l == 0 else hidden_size * ndir
                sfx = f"_l{l}" + ("_reverse" if d == 1 else "")
                for name_, shape, attr, bias in (
                        ("weight_ih", [g, in_sz], weight_ih_attr, False),
                        ("weight_hh", [g, hidden_size], weight_hh_attr,
                         False),
                        ("bias_ih", [g], bias_ih_attr, True),
                        ("bias_hh", [g], bias_hh_attr, True)):
                    self.add_parameter(name_ + sfx, self.create_parameter(
                        shape, attr=attr, is_bias=bias,
                        default_initializer=init))

    def _step(self):
        raise NotImplementedError

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else inputs.transpose(0, 1)
        T, batch = x.shape[0], x.shape[1]
        nl, nd, hs = self.num_layers, self.num_directions, self.hidden_size
        lstm = self.MODE == "LSTM"
        if initial_states is None:
            z = x.new_zeros((nl * nd, batch, hs))
            initial_states = (z, z) if lstm else z
        h0 = initial_states[0] if lstm else initial_states
        c0 = initial_states[1] if lstm else None
        valid = _valid(sequence_length, T, x.device)
        step = self._step()
        out = x
        last_h, last_c = [], []
        for l in range(nl):
            if l > 0 and self.dropout > 0.0:
                out = F.dropout(out, self.dropout, training=self.training)
            dirs = []
            for d in range(nd):
                sfx = f"_l{l}" + ("_reverse" if d == 1 else "")
                p = self._parameters
                xw = out @ p["weight_ih" + sfx].t() + p["bias_ih" + sfx]
                i = l * nd + d
                carry = (h0[i], c0[i]) if lstm else h0[i]
                seq, carry = _scan(step, xw, carry, p["weight_hh" + sfx],
                                   p["bias_hh" + sfx], valid, d == 1)
                dirs.append(seq)
                last_h.append(carry[0] if lstm else carry)
                if lstm:
                    last_c.append(carry[1])
            out = torch.cat(dirs, dim=-1) if nd == 2 else dirs[0]
        outputs = out if self.time_major else out.transpose(0, 1)
        h = torch.stack(last_h)
        if lstm:
            return outputs, (h, torch.stack(last_c))
        return outputs, h


class SimpleRNN(_RNNBase):
    MODE = "RNN_TANH"
    GATES = 1

    def _step(self):
        return _simple_step(_act(self.activation))


class LSTM(_RNNBase):
    MODE = "LSTM"
    GATES = 4

    def __init__(self, *args, **kwargs):
        kwargs.pop("activation", None)
        super().__init__(*args, **kwargs)

    def _step(self):
        return _lstm_step


class GRU(_RNNBase):
    MODE = "GRU"
    GATES = 3

    def __init__(self, *args, **kwargs):
        kwargs.pop("activation", None)
        super().__init__(*args, **kwargs)

    def _step(self):
        return _gru_step


class RNN(Layer):
    """A cell run over time (``is_reverse``: from the last step);
    ``sequence_length`` as in the layers above."""
    _torch_forward = True

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else inputs.transpose(0, 1)
        T = x.shape[0]
        valid = _valid(sequence_length, T, x.device)
        states = initial_states
        if states is None and valid is not None:
            states = _map(lambda s: s.to(x.dtype),
                          self.cell.get_initial_states(x[0]))
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if self.is_reverse else range(T)):
            o, new = self.cell(x[t], states)
            if valid is not None:
                m = valid[t]
                new = _map(lambda a, b: torch.where(m, a, b), new, states)
                o = torch.where(m, o, torch.zeros_like(o))
            outs[t] = o
            states = new
        return torch.stack(outs, dim=0 if self.time_major else 1), states


class BiRNN(Layer):
    """A forward and a backward :class:`RNN`, outputs concatenated."""
    _torch_forward = True

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        sf = initial_states[0] if initial_states else None
        sb = initial_states[1] if initial_states else None
        out_f, st_f = self.rnn_fw(inputs, sf, sequence_length)
        out_b, st_b = self.rnn_bw(inputs, sb, sequence_length)
        return torch.cat([out_f, out_b], dim=-1), (st_f, st_b)
