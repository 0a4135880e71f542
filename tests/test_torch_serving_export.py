"""``export_decode``: the decode step of both port engines as a
``torch.export`` program, restating the JAX round trips
(tests/test_serving_generation.py ``test_export_decode_roundtrip``,
tests/test_serving_paged.py ``test_export_decode_roundtrip``): bytes out,
``torch.export.load``, one step through the loaded module, and its
tokens and cache/pool writes equal to the live step's. The program holds
no weight bytes (weights and caches are inputs), its cache writes are
in-place nodes on the cache inputs (the loaded module writes the caches
passed to it), and K3 is in it as the operator
``paddle_tpu_torch::paged_attention``. The JAX package's
no-``[*, max_seq]`` pin (tests/test_serving_spec.py
``test_dense_decode_no_trailing_max_seq_intermediate``) is a shape check
over the exported dense graph's nodes at ``max_seq=48``. Two exports in
all, so the file stays quick."""
import io

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import LlamaDecodeEngine, PagedLlamaDecodeEngine
from test_torch_tensor import port_on_cpu  # noqa: F401

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, use_flash_attention=False)
MAX_SEQ = 48
K3 = "paddle_tpu_torch.paged_attention.default"


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(4)
    return LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")


def _clone(tree):
    return pytree.tree_map(lambda x: x.clone(), tree)


def _targets(ep):
    return [str(n.target) for n in ep.graph.nodes
            if n.op == "call_function"]


def _roundtrip(eng, cache_args):
    """Export, load, one step on copies of the live caches; then the
    live step. Returns the loaded program, its tokens and caches, the
    live tokens and caches."""
    blob = eng.export_decode()
    assert isinstance(blob, bytes) and len(blob) > 0
    ep = torch.export.load(io.BytesIO(blob))
    args = list(eng._export_args())
    for i in cache_args:
        args[i] = _clone(args[i])
    nxt = ep.module()(*args)
    want = eng.step()
    return ep, nxt, [args[i] for i in cache_args], want


def _mutated_inputs(ep):
    """Input placeholders an in-place node of the graph writes (through
    views of them)."""
    out = set()
    for n in ep.graph.nodes:
        if n.op != "call_function" or not str(n.target).endswith("_.default"):
            continue
        base = n.args[0]
        while getattr(base, "op", None) == "call_function" \
                and "view" in str(base.target):
            base = base.args[0]
        if getattr(base, "op", None) == "placeholder":
            out.add(base.name)
    return out


def _no_weights(ep):
    assert not ep.state_dict and not ep.constants
    assert ep.example_inputs is None


def test_dense_export_round_trip_and_max_seq_pin(model):
    eng = LlamaDecodeEngine(model, max_slots=3, max_seq=MAX_SEQ,
                            device="cpu")
    eng.prefill(0, [3, 4, 5])
    eng.prefill(2, list(range(7, 19)))
    ep, nxt, (kc, vc), want = _roundtrip(eng, (1, 2))
    assert nxt.dtype == torch.int32 and nxt.tolist() == want.tolist()
    for got, live in zip(kc + vc, eng.k_cache + eng.v_cache):
        assert torch.equal(got, live)
    _no_weights(ep)
    assert K3 in _targets(ep)
    # the cache writes mutate the cache inputs in place
    assert len(_mutated_inputs(ep)) == 2 * CFG["num_hidden_layers"]
    offenders = []
    for n in ep.graph.nodes:
        for v in pytree.tree_leaves(n.meta.get("val")):
            shape = tuple(getattr(v, "shape", ()))
            if shape and shape[-1] == MAX_SEQ:
                offenders.append((n.name, shape))
    assert offenders == []


def test_paged_export_round_trip(model):
    eng = PagedLlamaDecodeEngine(model, max_slots=2, max_seq=32,
                                 block_size=8, device="cpu")
    eng.prefill(0, [3, 4, 5], budget=8)
    eng._extend_tables()        # the step's tables, mapped before it
    ep, nxt, (stores,), want = _roundtrip(eng, (1,))
    assert nxt.tolist() == want.tolist()
    for got, live in zip(pytree.tree_leaves(stores),
                         pytree.tree_leaves(eng._kv_store)):
        assert torch.equal(got, live)
    _no_weights(ep)
    assert _targets(ep).count(K3) == CFG["num_hidden_layers"]
    assert len(_mutated_inputs(ep)) == 2 * CFG["num_hidden_layers"]
    # the block-pool signature: weights, pool stores, last ids,
    # positions, block tables, active mask
    names = [s.arg.name for s in ep.graph_signature.input_specs]
    n_weights = len(pytree.tree_leaves(eng.params))
    n_pools = len(pytree.tree_leaves(eng._kv_store))
    assert len(names) == n_weights + n_pools + 4
