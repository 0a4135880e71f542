"""The port's eager autograd against the JAX package's, on the CPU.

The scenarios of ``tests/test_autograd.py`` — backward through chains,
diamonds and shared inputs, accumulation, ``stop_gradient``,
``detach``, ``no_grad``, non-scalar roots, multi-output ops, indexing
and casts, ``retain_graph``, ``paddle.grad`` with ``allow_unused``,
hooks and double (and triple) grad with ``create_graph`` — each run as
one function of the package on ``paddle_tpu`` and on
``paddle_tpu_torch``; every gradient, value and flag it returns must
agree within 1e-6 (f32). The JAX tape and torch.autograd word their
errors differently: a scenario that must raise returns the exception
type it saw. ``PyLayer``, ``jacobian`` and ``hessian`` are not ported
yet.
"""
import numpy as np
import pytest

from test_torch_tensor import compare, port_on_cpu  # noqa: F401


def _raises(fn):
    try:
        fn()
    except RuntimeError:
        return "RuntimeError"
    return "no error"


def simple_chain(P):
    x = P.to_tensor([2.0, 3.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward()
    return [y, x.grad, y.stop_gradient, x.is_leaf, y.is_leaf]


def grad_accumulation(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    (x * 2).sum().backward()
    (x * 3).sum().backward()
    g = x.grad
    x.clear_grad()
    return [g, x.grad is None]


def diamond_graph(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    y = (x * 3) * (x * 4)
    y.backward()
    return [y, x.grad]


def shared_input_multi_consumer(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x.exp()
    (y + y * y).sum().backward()
    return [x.grad]


def stop_gradient_blocks(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    y = P.to_tensor([2.0])
    (x * y).sum().backward()
    return [x.grad, y.grad is None]


def detach_cuts_graph(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    y = (x * 2).detach()
    (y * 3).sum().backward()
    return [x.grad is None, y.stop_gradient]


def no_grad_context(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    with P.no_grad():
        y = x * 2
    return [y.stop_gradient, y]


def non_scalar_backward(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * x).backward(P.to_tensor([1.0, 0.5]))
    z = P.to_tensor([1.0, 2.0], stop_gradient=False)
    return [x.grad, _raises(lambda: (z * z).backward())]


def matmul_grad(P):
    rng = np.random.default_rng(0)
    a = P.to_tensor(rng.standard_normal((3, 4)).astype(np.float32),
                    stop_gradient=False)
    b = P.to_tensor(rng.standard_normal((4, 2)).astype(np.float32),
                    stop_gradient=False)
    P.matmul(a, b).sum().backward()
    return [a.grad, b.grad]


def broadcast_grad(P):
    x = P.to_tensor([[1.0, 2.0], [3.0, 4.0]], stop_gradient=False)
    b = P.to_tensor([1.0, 1.0], stop_gradient=False)
    ((x + b) ** 2).sum().backward()
    return [x.grad, b.grad]


def multi_output_grad(P):
    x = P.to_tensor([3.0, 1.0, 2.0], stop_gradient=False)
    vals, idx = P.topk(x, 2)
    vals.sum().backward()
    return [vals, idx, x.grad]


def getitem_grad(P):
    x = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    (x[1] * 5).backward()
    return [x.grad]


def cast_grad(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    x.astype("bfloat16").astype("float32").sum().backward()
    return [x.grad]


def backward_twice_retained(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    y = x * x
    y.backward(retain_graph=True)
    y.backward()
    return [x.grad]


def functional_grad(P):
    x = P.to_tensor(3.0, stop_gradient=False)
    (g,) = P.grad(x ** 2, x)
    return [g, x.grad is None, g.stop_gradient]


def grad_multiple_inputs(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    y = P.to_tensor(3.0, stop_gradient=False)
    return P.grad(x * y + x, [x, y])


def allow_unused(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    y = P.to_tensor(3.0, stop_gradient=False)
    z = x * 2
    err = _raises(lambda: P.grad(z, [x, y], retain_graph=True))
    gx, gy = P.grad(z, [x, y], allow_unused=True)
    return [err, gx, gy is None]


def hooks(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    seen = []
    h = x.register_hook(lambda g: seen.append(g.numpy()))
    (x * 2).sum().backward()
    h.remove()
    x.clear_grad()
    (x * 2).sum().backward()
    return [len(seen), seen[0], x.grad]


def hook_modifies_grad(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    x.register_hook(lambda g: g * 10)
    (x * 2).sum().backward()
    return [x.grad]


def retain_grads_nonleaf(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 3
    y.retain_grads()
    (y * y).sum().backward()
    return [y.grad, x.grad]


def second_order(P):
    x = P.to_tensor(3.0, stop_gradient=False)
    g, = P.grad(x * x * x, [x], create_graph=True)
    gg, = P.grad(g, [x])
    return [g, g.stop_gradient, gg]


def third_order(P):
    x = P.to_tensor(3.0, stop_gradient=False)
    g1, = P.grad(x * x * x, [x], create_graph=True)
    g2, = P.grad(g1, [x], create_graph=True)
    g3, = P.grad(g2, [x])
    return [g1, g2, g3]


def mixed_partial(P):
    a = P.to_tensor(2.0, stop_gradient=False)
    b = P.to_tensor(5.0, stop_gradient=False)
    ga, = P.grad(a * a * b, [a], create_graph=True)
    gab, = P.grad(ga, [b])
    return [ga, gab]


def double_grad_composition(P):
    x = P.to_tensor(np.array([0.3, 1.1, -0.7], np.float32),
                    stop_gradient=False)
    y = (P.sin(x) * x).sum()
    g, = P.grad(y, [x], create_graph=True)
    gg, = P.grad((g * g).sum(), [x])
    return [g, gg]


def double_grad_through_matmul(P):
    w = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3),
                    stop_gradient=False)
    x = P.to_tensor(np.ones((3, 2), dtype=np.float32), stop_gradient=False)
    gw, = P.grad(P.matmul(w, x).sum(), [w], create_graph=True)
    gx, = P.grad((gw * w).sum(), [w])
    return [gw, gx]


def hook_stays_differentiable(P):
    x = P.to_tensor(3.0, stop_gradient=False)
    x.register_hook(lambda g: g * 2)
    g, = P.grad(x * x * x, [x], create_graph=True)
    gg, = P.grad(g, [x])
    return [g, gg]


def freed_after_plain_backward(P):
    a = P.to_tensor(2.0, stop_gradient=False)
    b = a * a
    b.backward()
    return [_raises(lambda: P.grad(b, [a], create_graph=True))]


def retain_graph_keeps_double_grad(P):
    a = P.to_tensor(2.0, stop_gradient=False)
    c = a * a
    c.backward(retain_graph=True)
    g, = P.grad(c, [a], create_graph=True)
    return [g, a.grad]


SCENARIOS = [simple_chain, grad_accumulation, diamond_graph,
             shared_input_multi_consumer, stop_gradient_blocks,
             detach_cuts_graph, no_grad_context, non_scalar_backward,
             matmul_grad, broadcast_grad, multi_output_grad, getitem_grad,
             cast_grad, backward_twice_retained, functional_grad,
             grad_multiple_inputs, allow_unused, hooks, hook_modifies_grad,
             retain_grads_nonleaf, second_order, third_order, mixed_partial,
             double_grad_composition, double_grad_through_matmul,
             hook_stays_differentiable, freed_after_plain_backward,
             retain_graph_keeps_double_grad]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    compare(scenario)


def test_leaf_writes_keep_the_parameter():
    """``set_value`` / ``fill_`` / ``zero_`` / in-place ops on a leaf
    that requires grad write the wrapped tensor in place (torch refuses
    that outside ``no_grad``), so a layer's Parameter stays registered;
    gradients still flow afterwards."""
    import paddle_tpu_torch as P
    lin = P.nn.Linear(2, 2)
    w = lin.weight
    raw = w._t
    w.set_value(np.eye(2, dtype=np.float32))
    w.scale_(2.0)
    w[0, 1] = 1.0
    assert lin.weight._t is raw and not w.stop_gradient
    np.testing.assert_array_equal(w.numpy(), [[2.0, 1.0], [0.0, 2.0]])
    lin(P.ones([1, 2])).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), np.ones((2, 2)))
    w.zero_()
    w.fill_(0.5)
    assert float(lin.weight.sum()) == 2.0
