"""``paddle.profiler`` of the port, its native runtime and the merged
chrome trace, against the JAX package's, on the CPU.

The same program runs under both packages' ``Profiler`` (the host
plane): nested ``RecordEvent`` spans and three steps. The exported
traces hold the same span names with the same counts (``ProfileStep#n``
one a step), an inner span inside its outer one, the timeline's
counters (``"ph": "C"``) and the flight ring's instants (``"ph": "i"``).
A flight dump writes ``<dump>.trace.json`` beside itself and names it
in its header. ``utils.helpers`` behaves as the JAX module's. The
native library builds into the kernels' build directory (never into
``paddle_tpu/_native/``), atomically: two processes building at once
leave one loadable library; a failed build raises with the compiler's
output. The device plane (``ProfilerTarget.GPUTrace``) needs the card:
here it raises, on the card ``tests/test_torch_cuda.py`` reads it.
"""
import json
import os
import subprocess
import sys
import warnings

import pytest

import paddle_tpu as jpaddle
import paddle_tpu.profiler as jprof
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.profiler as tprof
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import timeline as jtimeline
from paddle_tpu_torch import _native
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.observability import timeline as ttimeline
from paddle_tpu_torch.utils import helpers as thelpers
from paddle_tpu.utils import helpers as jhelpers
from test_torch_tensor import port_on_cpu  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = [("jax", jprof, jtimeline, jflight), ("port", tprof, ttimeline,
                                              tflight)]


def _program(prof, timeline, flight, path):
    timer = timeline.StepTimer()
    p = prof.Profiler(targets=[prof.ProfilerTarget.CPU])
    p.start()
    for i in range(3):
        with prof.RecordEvent("outer"):
            with timer.phase("forward"):
                with prof.RecordEvent("inner"):
                    sum(range(1000))
        ev = prof.RecordEvent("reentrant")
        ev.begin()
        ev.begin()
        ev.end()
        ev.end()
        flight.record("test", "profiled_step", step=i)
        timer.step()
        p.step()
    p.stop()
    p.export(path)
    with open(path) as f:
        trace = json.load(f)
    return trace, p.summary(), timer


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    d = tmp_path_factory.mktemp("traces")
    out = {}
    for name, prof, timeline, flight in SIDES:
        trace, summary, timer = _program(prof, timeline, flight,
                                         str(d / f"{name}.json"))
        out[name] = (trace, summary)
        del timer
    return out


def _spans(trace):
    counts = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


def test_spans_and_steps_are_the_jax_ones(traces):
    j, t = (_spans(traces[s][0]) for s in ("jax", "port"))
    assert t == j
    assert t == {"outer": 3, "inner": 3, "reentrant": 6,
                 "ProfileStep#1": 1, "ProfileStep#2": 1, "ProfileStep#3": 1}


def test_inner_spans_nest_inside_outer_ones(traces):
    ev = [e for e in traces["port"][0]["traceEvents"] if e.get("ph") == "X"]
    outer = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e["name"] == "outer")
    inner = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e["name"] == "inner")
    for (o0, o1), (i0, i1) in zip(outer, inner):
        assert o0 <= i0 <= i1 <= o1
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e["name"].startswith("ProfileStep#"))
    for (a0, a1), (b0, _) in zip(steps, steps[1:]):
        assert a0 <= a1 <= b0 + 1e-3


def test_the_merge_holds_counters_and_instants(traces):
    for side in ("jax", "port"):
        ev = traces[side][0]["traceEvents"]
        counters = [e for e in ev if e.get("ph") == "C"]
        assert any("forward" in e.get("args", {}) for e in counters), side
        marks = [e for e in ev if e.get("ph") == "i"
                 and e.get("name") == "test.profiled_step"]
        assert len(marks) >= 3, side


def test_summary_names_the_spans(traces):
    for side in ("jax", "port"):
        s = traces[side][1]
        for name in ("outer", "inner", "ProfileStep#1"):
            assert name in s, (side, name)


def test_the_device_plane_needs_the_card():
    if tpaddle.device.cuda.device_count():
        pytest.skip("a card is present: tests/test_torch_cuda.py")
    p = tprof.Profiler(targets=[tprof.ProfilerTarget.GPUTrace])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.start()
    assert tprof.ProfilerTarget.TPU != tprof.ProfilerTarget.CPU


def test_a_flight_dump_writes_its_trace_beside_it(tmp_path):
    tflight.record("test", "before_dump")
    path = tflight.dump(str(tmp_path / "f.jsonl"), trigger="explicit")
    header, events = tflight.load_dump(path)
    assert header["chrome_trace"] == "f.jsonl.trace.json"
    with open(str(tmp_path / header["chrome_trace"])) as f:
        trace = json.load(f)
    assert any(e.get("name") == "test.before_dump"
               for e in trace["traceEvents"])
    assert any(e.get("name") == "before_dump" for e in events)


def test_helpers_are_the_jax_ones(capsys):
    for h in (jhelpers, thelpers):
        @h.deprecated(update_to="paddle.new", since="2.0", level=1)
        def old(x):
            """Old."""
            return x + 1
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert old(1) == 2
        assert any(issubclass(x.category, DeprecationWarning) for x in w)
        assert "Deprecated since 2.0" in old.__doc__

        @h.deprecated(level=2)
        def gone():
            pass
        with pytest.raises(RuntimeError, match="deprecated"):
            gone()
        h.require_version("0.0.1")
        with pytest.raises(Exception, match="required minimum"):
            h.require_version("99.0")
        with pytest.raises(TypeError):
            h.require_version(1)
        assert h.try_import("json") is json
        with pytest.raises(ImportError, match="pip install"):
            h.try_import("no_such_module_xyz")
    assert tpaddle.__version__ == jpaddle.__version__
    thelpers.run_check(device="cpu")
    assert "installed successfully" in capsys.readouterr().out
    if not tpaddle.device.cuda.device_count():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            thelpers.run_check()


def test_the_native_build_goes_to_the_build_dir_atomically(tmp_path):
    jax_native = os.path.join(ROOT, "paddle_tpu", "_native")
    before = {n: os.path.getmtime(os.path.join(jax_native, n))
              for n in os.listdir(jax_native)}
    env = dict(os.environ, PADDLE_TPU_TORCH_KERNEL_DIR=str(tmp_path),
               PYTHONPATH=ROOT)
    code = ("from paddle_tpu_torch import _native; m = _native.lib(); "
            "m.tracer_start(); print(_native.library_path())")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    built = sorted(os.listdir(tmp_path))
    assert [n for n in built if n.endswith(".so")] == \
        [os.path.basename(paths.pop())]
    assert not [n for n in built if n.endswith(".tmp")]
    after = {n: os.path.getmtime(os.path.join(jax_native, n))
             for n in os.listdir(jax_native)}
    assert after == before


def test_a_failed_native_build_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    bad = tmp_path / "native.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(_native, "SOURCE", bad)
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setenv("PADDLE_TPU_TORCH_KERNEL_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="build of native.cpp failed"):
        _native.lib()
    assert not list(tmp_path.glob("*.so"))
