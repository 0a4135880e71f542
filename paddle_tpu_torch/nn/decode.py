"""Seq2seq decoding of the port (``paddle_tpu/nn/decode.py``): the
``Decoder`` protocol, ``BeamSearchDecoder`` and ``dynamic_decode``.

The loop is host-driven, as in the JAX package: each step runs the cell,
the output function and the beam bookkeeping as torch ops on the
inputs' device, and ``dynamic_decode`` reads one bool a step (whether
every beam has finished). Beams carry the JAX package's state
(``cell_states``, ``log_probs``, ``finished``, ``lengths``): a finished
beam extends only with ``end_token`` at no cost, every other token costs
``kinf`` (1e9); the top ``beam_size`` of each batch row's ``beam ·
vocab`` totals pick the parents and tokens; the final sequences come from
the port's ``gather_tree``. The cell, ``embedding_fn`` and ``output_fn``
are called with Tensors, as the JAX decoder calls them.
"""
from __future__ import annotations

import collections

import torch

from ..core.tensor import Tensor

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]


def _map_structure(fn, *structs):
    s0 = structs[0]
    if isinstance(s0, (list, tuple)):
        return type(s0)(_map_structure(fn, *xs) for xs in zip(*structs))
    return fn(*structs)


def _data(t) -> torch.Tensor:
    """The raw tensor, off the tape: as in the JAX decoder, whose beam
    state is raw arrays, no gradient crosses a step."""
    return (t._t if isinstance(t, Tensor) else torch.as_tensor(t)).detach()


def _wrap(t):
    return t if isinstance(t, Tensor) else Tensor(t)


class Decoder:
    """The decode-step protocol: ``initialize``, ``step``, ``finalize``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over ``cell`` (a Layer returning ``(output,
    next_states)``); ``embedding_fn`` maps token ids to the cell's
    inputs, ``output_fn`` its output to vocabulary logits."""

    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = collections.namedtuple(
        "StateWrapper", ("cell_states", "log_probs", "finished", "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self.kinf = 1e9

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[batch, ...] -> [batch * beam, ...]`` (each row repeated
        ``beam_size`` times)."""
        def f(t):
            out = _data(t).repeat_interleave(beam_size, dim=0)
            return Tensor(out) if isinstance(t, Tensor) else out
        return _map_structure(f, x)

    def _expand_to_beam_size(self, x):
        a = _data(x)
        return a[:, None].expand((a.shape[0], self.beam_size) + a.shape[1:])

    def _merge_batch_beams(self, x):
        a = _data(x)
        return a.reshape((-1,) + a.shape[2:])

    def _split_batch_beams(self, x):
        a = _data(x)
        return a.reshape((-1, self.beam_size) + a.shape[1:])

    def _embed(self, ids):
        if self.embedding_fn is None:
            return ids
        return _data(self.embedding_fn(Tensor(ids)))

    def initialize(self, initial_cell_states):
        cell_states = _map_structure(
            lambda s: self._merge_batch_beams(self._expand_to_beam_size(s)),
            initial_cell_states)
        first = initial_cell_states
        while isinstance(first, (list, tuple)):
            first = first[0]
        first = _data(first)
        batch, dev = first.shape[0], first.device
        self.batch_size = batch
        log_probs = torch.tensor(
            [[0.0] + [-self.kinf] * (self.beam_size - 1)],
            dtype=torch.float32, device=dev).repeat(batch, 1)
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        lengths = torch.zeros((batch, self.beam_size), dtype=torch.int32,
                              device=dev)
        init_inputs = self._embed(torch.full(
            (batch * self.beam_size,), self.start_token, dtype=torch.int32,
            device=dev))
        state = self.StateWrapper(cell_states, log_probs, finished, lengths)
        return init_inputs, state, finished

    def step(self, time, inputs, states, **kwargs):
        cell_out, next_cell_states = self.cell(
            _wrap(inputs), _map_structure(_wrap, states.cell_states),
            **kwargs)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        logits = _data(cell_out)                       # [batch*beam, vocab]
        vocab = logits.shape[-1]
        step_lp = torch.log_softmax(logits.float(), dim=-1)
        step_lp = step_lp.reshape(self.batch_size, self.beam_size, vocab)

        # finished beams only extend with end_token, at no cost
        noend = torch.full((vocab,), -self.kinf, dtype=torch.float32,
                           device=logits.device)
        noend[self.end_token] = 0.0
        step_lp = torch.where(states.finished[:, :, None],
                              noend[None, None, :], step_lp)

        total = states.log_probs[:, :, None] + step_lp
        flat = total.reshape(self.batch_size, -1)
        top_scores, top_idx = torch.topk(flat, self.beam_size, dim=-1)
        parent = (top_idx // vocab).to(torch.int32)     # [batch, beam]
        token = (top_idx % vocab).to(torch.int32)

        was_finished = torch.gather(states.finished, 1, parent.long())
        next_finished = was_finished | (token == self.end_token)
        next_lengths = torch.gather(states.lengths, 1, parent.long()) + \
            (~was_finished).to(torch.int32)

        # the cell states of the parent beams
        flat_parent = (parent.long() + torch.arange(
            self.batch_size, device=parent.device)[:, None] *
            self.beam_size).reshape(-1)
        next_cell = _map_structure(lambda s: _data(s)[flat_parent],
                                   next_cell_states)

        next_state = self.StateWrapper(next_cell, top_scores, next_finished,
                                       next_lengths)
        out = self.OutputWrapper(top_scores, token, parent)
        return out, next_state, self._embed(token.reshape(-1)), \
            next_finished

    def finalize(self, outputs, final_states, sequence_lengths):
        from .functional.extension import gather_tree
        preds = gather_tree(Tensor(outputs.predicted_ids),
                            Tensor(outputs.parent_ids))
        return preds, final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder.step`` until every beam has finished or past
    ``max_step_num`` steps (one host read a step). -> ``(outputs,
    final_states)`` (``outputs`` batch-major unless
    ``output_time_major``), and the lengths with ``return_length``."""
    inputs, states, finished = decoder.initialize(inits)
    outputs_t = []
    step = 0
    limit = max_step_num if max_step_num is not None else 10 ** 9
    while not bool(_data(finished).all()) and step <= limit:
        out, states, inputs, finished = decoder.step(step, inputs, states,
                                                     **kwargs)
        outputs_t.append(out)
        step += 1
    seq_lens = states.lengths if hasattr(states, "lengths") else None
    if isinstance(outputs_t[0], tuple) and hasattr(outputs_t[0], "_fields"):
        stacked = type(outputs_t[0])(*[
            torch.stack([_data(getattr(o, f)) for o in outputs_t])
            for f in outputs_t[0]._fields])
    else:
        stacked = _map_structure(
            lambda *xs: torch.stack([_data(x) for x in xs]), *outputs_t)
    final_outputs, final_states = decoder.finalize(stacked, states, seq_lens)

    def to_batch_major(t):
        return Tensor(_data(t).transpose(0, 1))

    if not output_time_major:
        final_outputs = _map_structure(to_batch_major, final_outputs)
    if return_length:
        return final_outputs, final_states, Tensor(seq_lens)
    return final_outputs, final_states
