"""The port's ``core.random`` against the JAX package's, on the CPU.

Both modules export ``Generator``, ``TracedKeyStream``, ``key_stream``,
``next_key``, ``seed_epoch``, ``derive_seed``, ``get_rng_state`` /
``set_rng_state`` and ``RNGStatesTracker``; each scenario here runs on
both and holds the port to the JAX semantics: the ``(seed, counter)``
state and its round trip, the epoch bumped by every reseed or restore,
the tracker's errors, nested streams. The keys themselves differ (the
port mixes with its own function, written down in its docstring and
re-derived here with numpy); ``derive_seed`` of a port key equals the
JAX ``derive_seed`` of a JAX key with the same words.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import random as jrandom
from paddle_tpu_torch.core import random as trandom
from test_torch_tensor import port_on_cpu  # noqa: F401

MODULES = {"port": trandom, "jax": jrandom}


def _words(key):
    """A key's two words, either package's."""
    if isinstance(key, torch.Tensor):
        return [int(w) for w in key]
    return [int(w) for w in np.asarray(jax.random.key_data(key))]


def _fmix32(h):
    h = np.uint32(h)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def _fold_numpy(w0, w1, n):
    """The mixing as the module docstring writes it, in numpy uint32."""
    with np.errstate(over="ignore"):
        n32 = np.uint32(n & 0xFFFFFFFF)
        h0 = _fmix32(np.uint32(w0) + n32 * np.uint32(0x9E3779B1))
        h1 = _fmix32(np.uint32(w1) + n32 * np.uint32(0x85EBCA77))
        c = np.uint32(0x27D4EB2F)
        return [int(_fmix32(h0 ^ h1 * c)), int(_fmix32(h1 ^ h0 * c))]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
@pytest.mark.parametrize("n", [1, 2, 9])
def test_draws_are_the_documented_mixing(seed, n):
    g = trandom.Generator(seed)
    for _ in range(n - 1):
        g.next_key("cpu")
    want = _fold_numpy(seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, n)
    assert _words(g.next_key("cpu")) == want


@pytest.mark.parametrize("pkg", sorted(MODULES))
@pytest.mark.parametrize("n", [0, 1, 5])
def test_state_round_trip(pkg, n):
    """``(seed, counter)`` after ``n`` draws; ``set_state`` of it replays
    the same next draw."""
    mod = MODULES[pkg]
    g = mod.Generator(11)
    for _ in range(n):
        g.next_key(*(("cpu",) if pkg == "port" else ()))
    state = g.get_state()
    assert tuple(state) == (11, n) and g.initial_seed() == 11
    draw = (lambda: g.next_key("cpu")) if pkg == "port" else g.next_key
    a = _words(draw())
    g.manual_seed(99)
    draw()
    g.set_state(state)
    assert _words(draw()) == a
    assert tuple(g.get_state()) == (11, n + 1)


@pytest.mark.parametrize("pkg", sorted(MODULES))
@pytest.mark.parametrize("how", ["manual_seed", "set_state", "seed",
                                 "set_rng_state"])
def test_reseeding_bumps_the_epoch(pkg, how):
    mod = MODULES[pkg]
    g = mod.Generator(1)
    e0 = mod.seed_epoch()
    if how == "manual_seed":
        g.manual_seed(2)
    elif how == "set_state":
        g.set_state((2, 3))
    elif how == "seed":
        state = mod.get_rng_state()
        mod.seed(4)
        mod.set_rng_state(state)
    else:
        mod.set_rng_state(mod.get_rng_state())
    assert mod.seed_epoch() > e0


@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_tracker_names_raise_as_in_jax(pkg):
    mod = MODULES[pkg]
    tr = mod.RNGStatesTracker()
    tr.add("global", 1)
    tr.add("local", 2)
    with pytest.raises(ValueError, match="already exists"):
        tr.add("global", 3)
    with pytest.raises(ValueError, match="Unknown RNG state"):
        tr.rng_state("model_parallel")
    with pytest.raises(ValueError, match="Unknown RNG state"):
        tr.next_key("model_parallel")
    assert tr.rng_state("local").get_state() == (2, 0)
    args = ("cpu",) if pkg == "port" else ()
    a = tr.next_key("global", *args)
    b = tr.next_key("local", *args)
    assert _words(a) != _words(b)
    assert tr.rng_state("global").get_state() == (1, 1)


@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_nested_key_streams(pkg):
    """The innermost stream serves ``next_key``; leaving it the outer
    one goes on where it stopped; outside both the default generator
    serves, untouched by the streams' draws."""
    mod = MODULES[pkg]
    if pkg == "port":
        k1, k2 = torch.tensor([1, 2]), torch.tensor([3, 4])

        def fold(k, n):
            return _fold_numpy(int(k[0]), int(k[1]), n)
    else:
        k1, k2 = jax.random.key(1), jax.random.key(2)

        def fold(k, n):
            return _words(jax.random.fold_in(k, n))
    mod.seed(5)
    before = mod.get_rng_state()
    with mod.key_stream(k1) as s1:
        a = mod.next_key()
        with mod.key_stream(k2):
            b = mod.next_key()
        c = mod.next_key()
        assert isinstance(s1, mod.TracedKeyStream)
    assert [_words(a), _words(b), _words(c)] == \
        [fold(k1, 1), fold(k2, 1), fold(k1, 2)]
    assert mod.get_rng_state() == before
    mod.next_key()
    assert mod.get_rng_state() == (5, 1)


@pytest.mark.parametrize("words", [(0, 0), (1, 2), (0xDEADBEEF, 0x80000000),
                                   (0xFFFFFFFF, 0x7FFFFFFF)],
                         ids=["zeros", "small", "high_bit", "ones_max"])
@pytest.mark.parametrize("dtype", ["int32", "uint32"])
def test_derive_seed_matches_jax(words, dtype):
    """The last word, bitcast: a port key and a JAX key with the same
    words fold to the same 32-bit seed."""
    jkey = jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32))
    want = int(jrandom.derive_seed(jkey, getattr(jnp, dtype)))
    got = trandom.derive_seed(torch.tensor(words, dtype=torch.int64),
                              None if dtype == "int32" else "uint32")
    assert got.dim() == 0 and int(got) == want
    assert got.dtype == (torch.int32 if dtype == "int32" else torch.int64)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_nth_draw_is_the_same_eager_and_after_set_state(n):
    """The n-th draw after a seed is one key, whether the stream got
    there by draws or by ``set_rng_state``; a host draw takes a place in
    the same stream (the key it seeds from is the device draw's)."""
    trandom.seed(21)
    keys = [trandom.next_key("cpu") for _ in range(n)]
    trandom.set_rng_state((21, n - 1))
    assert torch.equal(trandom.next_key("cpu"), keys[-1])
    trandom.set_rng_state((21, n - 1))
    lo, hi = trandom.default_generator()._host_key()
    assert [lo, hi] == _words(keys[-1])
    assert trandom.get_rng_state() == (21, n)


def test_draws_count_host_draws_only():
    d0 = trandom.draws()
    trandom.next_key("cpu")
    trandom.derive_seed(trandom.next_key("cpu"))
    assert trandom.draws() == d0
    trandom.generator_for("cpu")
    trandom.device_generator("cpu")
    assert trandom.draws() == d0 + 2


def test_a_device_state_follows_the_host_counter():
    """A draw on one device after draws elsewhere brings that device's
    state up to the host counter first (a fill, no host read)."""
    g = trandom.Generator(3)
    a = g.next_key("cpu")
    g._host_key()
    st = g.prepare("cpu")
    assert st.tolist() == [3, 0, 2]
    b = g.next_key("cpu")
    assert _words(b) == _fold_numpy(3, 0, 3) and _words(a) == \
        _fold_numpy(3, 0, 1)
    assert g.prepare("cpu").data_ptr() == st.data_ptr()
    g.manual_seed(2 ** 33 + 5)
    assert st.tolist() == [5, 2, 0]


def test_key_observer_sees_every_next_key():
    seen = []
    prev = trandom._key_observer
    trandom._key_observer = lambda: seen.append(1)
    try:
        trandom.next_key("cpu")
        with trandom.key_stream(torch.tensor([1, 1])):
            trandom.next_key()
    finally:
        trandom._key_observer = prev
    assert len(seen) == 2


def test_keys_and_hash_seeds_do_not_repeat():
    """2,000 draws of one stream and the first draw of 2,000 seeds:
    no two keys equal, no two derived seeds equal."""
    g = trandom.Generator(0)
    ks = [tuple(_words(g.next_key("cpu"))) for _ in range(2000)]
    firsts = [tuple(_words(trandom.Generator(s).next_key("cpu")))
              for s in range(2000)]
    for keys in (ks, firsts):
        assert len(set(keys)) == len(keys)
        assert len({k[1] for k in keys}) == len(keys)


def test_generator_is_thread_safe():
    g = trandom.Generator(4)
    out = []

    def work():
        out.extend(tuple(_words(g.next_key("cpu"))) for _ in range(200))
    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert g.get_state() == (4, 800) and len(set(out)) == 800


def test_a_forked_child_keeps_its_cpu_states_only():
    """After a fork (a DataLoader worker reseeds in its child), the
    parent's device states are dropped: a reseed there writes CPU
    memory only. A meta-device state stands in for the card's."""
    g = trandom.Generator(6)
    g.prepare("meta")
    cpu = g.prepare("cpu")
    trandom._forget_device_states()
    assert list(g._states) == [torch.device("cpu")]
    assert g._states[torch.device("cpu")] is cpu
    g.manual_seed(7)
    assert cpu.tolist() == [7, 0, 0]
    assert _words(g.next_key("cpu")) == _fold_numpy(7, 0, 1)
