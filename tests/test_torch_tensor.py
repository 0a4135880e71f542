"""The port's eager Tensor against the JAX package's, on the CPU.

Each scenario of ``tests/test_tensor.py`` (creation, methods,
operators, indexing, in-place writes) runs as one function of the
package, once with ``paddle_tpu`` and once with ``paddle_tpu_torch``;
every value it returns must agree within 1e-6 (f32) and every dtype
must map (``dtype_name`` on both sides). The one allowed dtype
difference is the JAX package's int32 (float32) where the port keeps
int64 (float64): JAX runs with x64 off. Random draws cannot match JAX's threefry: the port
is held to the shapes, ranges, statistics and seed determinism alone.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.core import dtype as jdtype
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.core import dtype as tdtype

ATOL = RTOL = 1e-6
# the JAX package narrows int64 to int32 and float64 to float32 (x64
# off); the port keeps 64 bits
DTYPE_ALLOWED = {("int32", "int64"), ("float32", "float64")}


@pytest.fixture(autouse=True)
def port_on_cpu():
    """The port's eager core on the CPU for the test (its default is
    the card), the previous device restored after; one torch thread
    (these tests make many calls on tiny tensors, which torch's
    intra-op threads slow down beside the other workers of a parallel
    run, as ``test_torch_flash_attention.py`` notes)."""
    prev, threads = tdevice._current, torch.get_num_threads()
    tdevice.set_device("cpu")
    torch.set_num_threads(1)
    yield
    tdevice._current = prev
    torch.set_num_threads(threads)


def _norm(v):
    """A result as (numpy value, dtype name) — Tensors of either
    package, numpy arrays and Python values."""
    if isinstance(v, jpaddle.Tensor):
        return np.asarray(v.astype("float32")._data
                          if v.dtype == jdtype.bfloat16 else v._data), \
            jdtype.dtype_name(v.dtype)
    if isinstance(v, tpaddle.Tensor):
        return v.numpy(), tdtype.dtype_name(v.dtype)
    return np.asarray(v), None


def _flatten(out):
    if isinstance(out, (list, tuple)) and not (
            out and all(isinstance(v, int) for v in out)):
        return [x for o in out for x in _flatten(o)]
    return [out]


def compare(scenario, atol=ATOL, rtol=RTOL):
    """Run ``scenario(paddle)`` on both packages and hold the port's
    results to the JAX package's, position by position."""
    want = _flatten(scenario(jpaddle))
    got = _flatten(scenario(tpaddle))
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        (wv, wd), (gv, gd) = _norm(w), _norm(g)
        assert wd == gd or (wd, gd) in DTYPE_ALLOWED, (i, wd, gd)
        assert wv.shape == gv.shape, (i, wv.shape, gv.shape)
        if wv.dtype.kind in "fc" or gv.dtype.kind in "fc":
            np.testing.assert_allclose(gv.astype(np.float64),
                                       wv.astype(np.float64), atol=atol,
                                       rtol=rtol, err_msg=f"result {i}")
        else:
            np.testing.assert_array_equal(gv, wv, err_msg=f"result {i}")


def _x(shape=(3, 4), seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


# -- scenarios: each takes the package (paddle_tpu or paddle_tpu_torch) --

def creation_to_tensor(P):
    t = P.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    return [t, t.shape, P.to_tensor([1, 2, 3], dtype="float32"),
            P.to_tensor([1, 2, 3]), P.to_tensor(3.5), P.to_tensor(True)]


def creation_constants(P):
    x = P.ones([2, 2])
    return [P.zeros([2, 3]), P.ones([2, 3]), P.full([2], 7.0),
            P.full([2, 2], 3, dtype="int32"), P.zeros_like(x),
            P.ones_like(x, dtype="int32"), P.full_like(x, 3),
            P.empty([2]), P.empty_like(x)]


def creation_ranges(P):
    return [P.arange(5), P.arange(1, 7, 2), P.arange(0.0, 1.0, 0.25),
            P.arange(3, dtype="float32"), P.linspace(0, 1, 5), P.eye(3),
            P.eye(2, 4)]


def creation_tri_diag(P):
    x = P.to_tensor(_x((3, 3)))
    v = P.to_tensor([1.0, 2.0, 3.0])
    return [P.tril(x), P.triu(x, 1), P.tril(x, -1), P.diag(v),
            P.diag(v, offset=1), P.diag(x), P.diag(v, padding_value=5.0),
            P.meshgrid(v, P.to_tensor([4.0, 5.0])), P.assign(x),
            P.clone(x)]


def methods_properties(P):
    t = P.ones([2, 3, 4])
    return [t.ndim, t.size, t.numel(), len(t), t.shape, t.dim()]


def methods_item(P):
    return [P.to_tensor(3.5).item(), float(P.to_tensor([2.0]).sum()),
            int(P.to_tensor([7])), P.to_tensor([[1, 2], [3, 4]]).tolist()]


def methods_astype(P):
    t = P.to_tensor([1.7, -2.3])
    return [t.astype("int32"), t.astype("float16"), t.cast("bfloat16"),
            t.astype("bool"), P.cast(t, "int64")]


def operators_arith(P):
    a = P.to_tensor([1.0, 2.0])
    b = P.to_tensor([3.0, 4.0])
    return [a + b, a - b, a * b, b / a, a ** 2, 2.0 * a, 1.0 - a, -a,
            a + 1, 2 ** a, b // a, b % a, 5.0 / a, abs(-a), a @ b]


def operators_int(P):
    a = P.to_tensor([7, -7, 5])
    b = P.to_tensor([2, 2, -3])
    return [a + b, a * b, a // b, a % b, a - 1, a / b]


def operators_compare(P):
    a = P.to_tensor([1.0, 5.0, 2.0])
    b = P.to_tensor([2.0, 2.0, 2.0])
    m = P.to_tensor([True, False, True])
    n = P.to_tensor([True, True, False])
    return [a < b, a >= b, a == b, a != b, a > b, a <= b, m & n, m | n,
            m ^ n, ~m]


def operators_matmul(P):
    a = P.to_tensor(_x((2, 3)))
    b = P.to_tensor(_x((3, 4), 1))
    return [a @ b, (a @ b).shape]


def indexing_get(P):
    t = P.to_tensor(np.arange(24.0, dtype=np.float32).reshape(2, 3, 4))
    i = P.to_tensor([1, 0], dtype="int64")
    return [t[0, 1], t[1], t[:, 2], t[0:2, 0:2], t[..., -1], t[:, ::2],
            t[0, [0, 2]], t[i], t[t > 20], t[None].shape, t[-1, -1, -1]]


def indexing_set(P):
    t = P.zeros([3, 3])
    t[1, 1] = 5.0
    t[0] = P.to_tensor([1.0, 2.0, 3.0])
    t[:, 2] = 7.0
    u = P.to_tensor(np.arange(6.0, dtype=np.float32))
    u[u > 3] = 0.0
    return [t, u]


def methods_patched(P):
    t = P.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    return [t.sum(), t.mean(), t.reshape([4]), t.transpose([1, 0]),
            t.exp(), t.max(), t.argmax(), t.sum(axis=0), t.abs(),
            t.matmul(t), t.unsqueeze(0), t.flatten(), t.split(2),
            t.clip(1.5, 3.5), t.t(), t.pow(2), t.equal(t)]


def inplace_writes(P):
    t = P.ones([2])
    t.add_(P.ones([2]))
    r1 = t.numpy().copy()
    t.set_value(np.array([5.0, 6.0], np.float32))
    r2 = t.numpy().copy()
    t.scale_(2.0)
    r3 = t.numpy().copy()
    t.zero_()
    r4 = t.numpy().copy()
    t.fill_(3.0)
    u = P.to_tensor([[1.0, 4.0]])
    u.sqrt_()
    u.reshape_([2])
    v = P.to_tensor([1.0, -2.0])
    v.clip_(-1.0, 0.5)
    w = P.to_tensor([1.0, 2.0])
    P.increment(w, 2.0)
    return [r1, r2, r3, r4, t, u, v, w]


def detach_clone(P):
    t = P.to_tensor([1.0], stop_gradient=False)
    d = t.detach()
    c = t.clone()
    return [d.stop_gradient, c.stop_gradient, t.stop_gradient,
            P.to_tensor([1.0]).stop_gradient, d, c]


def grad_modes(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    with P.no_grad():
        y = x * 2
    with P.no_grad():
        with P.enable_grad():
            z = x * 2
    with P.set_grad_enabled(False):
        w = x * 2

    @P.no_grad()
    def f(a):
        return a * 3
    return [y.stop_gradient, z.stop_gradient, w.stop_gradient,
            f(x).stop_gradient, P.is_grad_enabled()]


def dtype_surface(P):
    prev = P.get_default_dtype()
    P.set_default_dtype("float64")
    try:
        a = P.to_tensor([1.5])
        b = P.zeros([1])
        return [a, b, P.get_default_dtype() == P.float64]
    finally:
        P.set_default_dtype(prev)


SCENARIOS = [creation_to_tensor, creation_constants, creation_ranges,
             creation_tri_diag, methods_properties, methods_item,
             methods_astype, operators_arith, operators_int,
             operators_compare, operators_matmul, indexing_get,
             indexing_set, methods_patched, inplace_writes, detach_clone,
             grad_modes, dtype_surface]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    compare(scenario)


def test_dtype_names_map():
    for name in ("bool", "uint8", "int8", "int16", "int32", "int64",
                 "float16", "bfloat16", "float32", "float64", "complex64",
                 "complex128"):
        assert tdtype.dtype_name(tdtype.convert_dtype(name)) == name
        assert tdtype.convert_dtype(name) == getattr(
            torch, name if name != "bool" else "bool")
    assert tdtype.convert_dtype(np.float32) == torch.float32
    assert tpaddle.bool is torch.bool and tpaddle.float32 is torch.float32


def test_random_shapes_ranges_and_stats():
    tpaddle.seed(42)
    a = tpaddle.randn([400, 50])
    assert a.shape == [400, 50] and a.dtype == torch.float32
    assert abs(float(a.mean())) < 0.02 and abs(float(a.std()) - 1) < 0.02
    b = tpaddle.uniform([1000], min=2.0, max=3.0)
    assert (b.numpy() >= 2).all() and (b.numpy() < 3).all()
    c = tpaddle.randint(0, 10, [200])
    assert c.dtype == torch.int64
    assert ((c.numpy() >= 0) & (c.numpy() < 10)).all()
    p = tpaddle.randperm(10)
    assert sorted(p.tolist()) == list(range(10))
    r = tpaddle.rand([3])
    assert ((r.numpy() >= 0) & (r.numpy() < 1)).all()
    n = tpaddle.normal(1.0, 0.0, [4])
    np.testing.assert_array_equal(n.numpy(), np.ones(4, np.float32))
    m = tpaddle.multinomial(tpaddle.to_tensor([0.0, 1.0, 0.0]), 3, True)
    assert m.tolist() == [1, 1, 1]
    k = tpaddle.bernoulli(tpaddle.to_tensor([0.0, 1.0]))
    assert k.tolist() == [0.0, 1.0]
    z = tpaddle.zeros([2000])
    z.uniform_(-1.0, 1.0)
    assert float(z.min()) >= -1 and float(z.max()) < 1
    z.normal_(0.0, 1.0)
    assert abs(float(z.mean())) < 0.1


def test_seed_determinism():
    """As ``tests/test_tensor.py:48``: one seed, one draw."""
    draws = []
    for _ in range(2):
        tpaddle.seed(7)
        draws.append((tpaddle.randn([8]).numpy(),
                      tpaddle.randint(0, 100, [5]).numpy(),
                      tpaddle.nn.initializer.Normal()((3,), "float32",
                                                      "cpu").numpy()))
    for a, b in zip(*draws):
        np.testing.assert_array_equal(a, b)
    state = tpaddle.get_rng_state()
    x = tpaddle.randn([4]).numpy()
    tpaddle.set_rng_state(state)
    np.testing.assert_array_equal(tpaddle.randn([4]).numpy(), x)


def test_places_and_devices():
    t = tpaddle.to_tensor([1.0])
    assert t.place == tpaddle.CPUPlace()
    assert tpaddle.get_device() == "cpu"
    assert tpaddle.device_count("cpu") == 1
    assert tpaddle.CUDAPlace(0) != tpaddle.CPUPlace()
    assert isinstance(tpaddle.is_compiled_with_cuda(), bool)
    assert t.to("cpu").place == tpaddle.CPUPlace()
    assert tpaddle.to_tensor([1.0], place="cpu").place == tpaddle.CPUPlace()


def test_default_device_is_the_card(monkeypatch):
    """Without ``set_device`` the eager core makes tensors on the card,
    and without CUDA it raises instead of falling back."""
    monkeypatch.setattr(tdevice, "_current", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpaddle.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpaddle.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpaddle.set_device("gpu")


def test_torch_functions_take_tensors():
    """``__torch_function__``: a torch function given a Tensor returns
    a Tensor (and torch tensors stay torch tensors in apply_op)."""
    t = tpaddle.to_tensor([[1.0, 2.0]])
    out = torch.nn.functional.linear(t, torch.ones(3, 2))
    assert isinstance(out, tpaddle.Tensor) and out.shape == [1, 3]
    raw = tpaddle.add(torch.ones(2), torch.ones(2))
    assert type(raw) is torch.Tensor
    both = torch.ones(1, 2) + t
    assert isinstance(both, tpaddle.Tensor)
