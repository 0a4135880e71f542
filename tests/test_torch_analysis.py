"""The port's analysis plane against the JAX package's, on the CPU.

The linter and the static capture scan run on the same seeded sources
in both packages: the same rule ids at the same lines. The port adds
``.cpu()`` to the host reads (PTL001, PTC003): a source with one gives
the port one more finding there, and only there. ``shapes.abstract_eval``
gives the JAX module's ``(shape, dtype)`` for every ``shape:`` spec of
``ops.yaml`` on every sample case, and the port's specs all agree with
its live ops on meta tensors. The auditor counts a small step's host
syncs by call site, with the JAX auditor's counts at the same lines;
a step on the CPU falls back ``"device"``, a break the capture plan
classifies, and the plan of a step with a host read covers the read
with a static finding.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.analysis import auditor as jauditor
from paddle_tpu.analysis import capture as jcapture
from paddle_tpu.analysis.lint import lint_source as jlint_source
from paddle_tpu.analysis import shapes as jshapes
from paddle_tpu_torch.analysis import auditor as tauditor
from paddle_tpu_torch.analysis import capture as tcapture
from paddle_tpu_torch.analysis import shapes as tshapes
from paddle_tpu_torch.analysis.lint import lint_source as tlint_source
from paddle_tpu_torch.analysis.planner import capture_plan
from test_torch_tensor import port_on_cpu  # noqa: F401

LINT_SOURCES = [
    "REG = {}\n"
    "def evict():\n"
    "    REG.clear()\n"
    "    del REG['a']\n"
    "    try:\n"
    "        pass\n"
    "    except:\n"
    "        pass\n",
    "import numpy as np\n"
    "def f(t, lock):\n"
    "    a = t.numpy()\n"
    "    b = t.sum().item()\n"
    "    c = np.asarray([1]).item()\n"
    "    with lock:\n"
    "        CACHE = {}\n"
    "    return t.tolist(), a, b, c\n",
    "from ..core.flags import define_flag\n"
    "define_flag('never_read', 0)\n"
    "def g(x):\n"
    "    return x.mean()\n",
]

SCAN_SOURCES = [
    "def step(x):\n"
    "    import paddle\n"
    "    t = paddle.multiply(x, 2.0)\n"
    "    if t.sum().item() > 0:\n"
    "        t = paddle.add(t, 1.0)\n"
    "    t[0] = 0.0\n"
    "    mask = t > 0.5\n"
    "    sel = t[mask]\n"
    "    return sel.numpy()\n",
    "def step(self, x):\n"
    "    import paddle\n"
    "    y = paddle.nn.functional.dropout(x, 0.5)\n"
    "    self.count += 1\n"
    "    print(y.shape)\n"
    "    while float(y.mean()) > 0:\n"
    "        y = y - 1\n"
    "    return y\n",
]


def _ids(diags):
    return sorted((d.rule, d.location) for d in diags)


@pytest.mark.parametrize("i", range(len(LINT_SOURCES)))
def test_lint_gives_the_jax_rules_at_the_jax_lines(i):
    src = LINT_SOURCES[i]
    assert _ids(tlint_source(src)) == _ids(jlint_source(src))
    assert tlint_source(src) or i == 2


@pytest.mark.parametrize("i", range(len(SCAN_SOURCES)))
def test_the_capture_scan_gives_the_jax_rules_at_the_jax_lines(i):
    src = SCAN_SOURCES[i]
    got = _ids(tcapture.scan_source(src))
    assert got == _ids(jcapture.scan_source(src))
    assert got


def test_cpu_is_a_host_read_in_the_port_only():
    src = ("def step(x):\n"
           "    import paddle\n"
           "    t = paddle.multiply(x, 2.0)\n"
           "    return t.cpu()\n")
    extra = set(_ids(tcapture.scan_source(src))) - \
        set(_ids(jcapture.scan_source(src)))
    assert extra == {("PTC003", "<step>:4")}
    lsrc = "def f(t):\n    return t.cpu()\n"
    assert _ids(tlint_source(lsrc)) == [("PTL001", "<snippet>:2")]
    assert _ids(jlint_source(lsrc)) == []


def _jax_aval(aval):
    import jax.numpy as jnp
    return jshapes.AVal(aval.shape, jnp.dtype(str(aval.dtype)[6:]))


def test_abstract_eval_is_the_jax_one_for_every_spec():
    from paddle_tpu_torch.ops.op_registry import OP_TABLE
    n = 0
    for op, info in sorted(OP_TABLE.items()):
        spec = info["shape_spec"]
        if not spec:
            continue
        for avals, attrs in tshapes._sample_cases(op, spec):
            tav = [tshapes.AVal(s, d) for s, d in avals]
            got = tshapes.abstract_eval(op, tav, attrs)
            jattrs = tuple((k, np.dtype(str(v)[6:])
                            if isinstance(v, torch.dtype) else v)
                           for k, v in (attrs or ()))
            want = jshapes.abstract_eval(op, [_jax_aval(a) for a in tav],
                                         jattrs)
            assert (got is None) == (want is None), (op, avals)
            if got is not None:
                assert got.shape == want.shape, (op, avals, got, want)
                assert str(got.dtype)[6:] == str(want.dtype), (op, avals)
            n += 1
    assert n > 200


def test_every_spec_agrees_with_the_live_op():
    assert tshapes.validate_specs() == []
    seeded = tshapes.validate_op("matmul", "elementwise")
    assert [d.rule for d in seeded] == ["PTC005"]


def _step(P):
    x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    y = x * 2.0
    a = y.numpy()
    b = (y + 1).numpy()
    c = y.sum().item()
    return a, b, c


def test_the_auditor_counts_syncs_by_call_site():
    t = tauditor.audit(_step, tpaddle, warmup=1)
    j = jauditor.audit(_step, jpaddle, warmup=1)

    def by_line(rep):
        out = {}
        for ev in rep.syncs:
            path, line = ev["origin"].rsplit(":", 1)
            assert path.endswith("test_torch_analysis.py"), ev
            out[(int(line), ev["kind"])] = \
                out.get((int(line), ev["kind"]), 0) + 1
        return out
    assert by_line(t) == by_line(j)
    assert sorted(by_line(t).values()) == [1, 1, 1]
    assert sorted(d.rule for d in t.diagnostics) == ["PTA001"] * 3
    assert t.result[2] == 30.0


def test_breaks_and_the_plan_on_the_cpu():
    net = tpaddle.nn.Linear(3, 2)
    opt = tpaddle.optimizer.AdamW(1e-2, parameters=net.parameters())
    step = tpaddle.jit.TrainStep(net, lambda out, y: ((out - y) ** 2)
                                 .mean(), opt)
    x = tpaddle.to_tensor(np.ones((4, 3), np.float32))
    y = tpaddle.to_tensor(np.zeros((4, 2), np.float32))

    def train():
        import paddle_tpu_torch as paddle
        loss = paddle.mean(step(x, y))
        return float(loss)
    rep = tauditor.audit(train, warmup=2)
    assert [b["reason"] for b in rep.breaks] == ["device"]
    assert rep.breaks[0]["origin"].startswith("tests/test_torch_analysis")
    plan = capture_plan(train, warmup=2)
    rows = {b["reason"]: b for b in plan.breaks}
    assert rows["device"]["classification"] == "compatible"
    # the float(loss) read is covered by the scan of train's own source
    assert rows["host_sync"]["rule"] == "PTC003"
    assert plan.consistent()
