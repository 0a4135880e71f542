"""``paddle.device``'s memory counters on the CPU, against the JAX
package's.

On the CPU both packages count with an op-boundary tracker: every eager
op output and ``to_tensor`` result adds its bytes, and the bytes go
when the buffer dies. The same op sequence, with frees, moves
``memory_allocated`` and ``max_memory_allocated`` (after a peak reset)
by the same bytes in both. Views are where the two differ: a JAX slice
is a new buffer, a torch view shares its base's storage, which stays
counted, once, until its last view dies.
"""
import gc

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from test_torch_tensor import port_on_cpu  # noqa: F401


@pytest.fixture(autouse=True)
def _no_collector():
    """Frees come from reference counts alone while a test reads: the
    collector runs once before and not during, so no unrelated
    garbage moves the counters mid-sequence."""
    gc.collect()
    gc.disable()
    yield
    gc.enable()


@pytest.fixture(scope="module", autouse=True)
def _jax_fusion_off():
    """The JAX side runs its ops eagerly, so each output is a buffer
    when the counters are read."""
    prev = jpaddle.get_flags("FLAGS_eager_fusion")
    jpaddle.set_flags({"FLAGS_eager_fusion": False})
    yield
    jpaddle.set_flags(prev)


def _reader(paddle):
    dev = paddle.device
    arg = ("cpu",) if paddle is tpaddle else ()
    dev.reset_max_memory_allocated(*arg)
    cur0, peak0 = dev.memory_allocated(*arg), dev.max_memory_allocated(*arg)

    def read():
        return (dev.memory_allocated(*arg) - cur0,
                dev.max_memory_allocated(*arg) - peak0)
    return read


def _sequence(paddle):
    """(current, peak) deltas after each step of one op sequence."""
    read = _reader(paddle)
    rng = np.random.default_rng(0)
    out = []
    a = paddle.to_tensor(rng.standard_normal((64, 64)).astype("float32"))
    out.append(read())
    b = paddle.to_tensor(rng.standard_normal((64, 32)).astype("float32"))
    out.append(read())
    c = paddle.matmul(a, b)
    out.append(read())
    d = paddle.exp(c)
    out.append(read())
    del a
    out.append(read())
    e = paddle.concat([c, d], axis=1)
    out.append(read())
    del c, d
    out.append(read())
    f = paddle.to_tensor(rng.standard_normal((128, 128)).astype("float32"))
    out.append(read())
    del b, e, f
    out.append(read())
    return out


def test_cpu_memory_counters_equal_the_jax_packages(port_on_cpu):  # noqa: F811
    want = _sequence(jpaddle)
    got = _sequence(tpaddle)
    assert got == want
    # the sequence allocates, frees and peaks where it should
    assert got[3] == (40960, 40960)
    assert got[-1] == (0, 90112)


def test_a_view_keeps_its_storage_counted_until_it_dies(
        port_on_cpu):  # noqa: F811
    read = _reader(tpaddle)
    a = tpaddle.to_tensor(np.ones((64, 64), "float32"))
    assert read() == (16384, 16384)
    v = a[:8]
    w = tpaddle.reshape(a, [4096])
    assert read() == (16384, 16384)  # views share the storage: no bytes
    del a, w
    assert read() == (16384, 16384)  # the view holds the storage
    assert v.shape == [8, 64]
    del v
    assert read() == (0, 16384)
    # a detached alias holds no reference to its source tensor
    b = tpaddle.to_tensor(np.ones((64, 64), "float32"))
    x = b.detach()
    del b
    assert read() == (16384, 16384)
    assert x.shape == [64, 64]
    del x
    assert read() == (0, 16384)
