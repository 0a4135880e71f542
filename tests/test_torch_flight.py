"""The flight recorder: the port's ``observability.flight`` and its CLI
against the JAX package's.

Ring semantics (the kill switch, the capacity flag and its resize, the
filters, ``appended`` / ``dropped``, chrome events), dumps (the JSONL
header and event lines, ``load_dump``, ``find_dumps``,
``render_events``, the ``dumps_total`` counter), the crash hooks
installed and uninstalled, and ``python -m
paddle_tpu_torch.observability --flight``. A dump of the same ring
holds the same event lines in both packages, and both CLIs render a
dump alike.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import paddle_tpu as paddle
from paddle_tpu.observability import __main__ as jcli
from paddle_tpu.observability import flight as jflight
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.observability import __main__ as tcli
from paddle_tpu_torch.observability import flight
from paddle_tpu_torch.observability import metrics as om

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def dump_dir(tmp_path):
    """Both packages' dumps under the test's directory."""
    prev, jprev = (get_flags("FLAGS_flight_dump_dir"),
                   paddle.get_flags("FLAGS_flight_dump_dir"))
    set_flags({"FLAGS_flight_dump_dir": str(tmp_path)})
    paddle.set_flags({"FLAGS_flight_dump_dir": str(tmp_path)})
    try:
        yield str(tmp_path)
    finally:
        set_flags(prev)
        paddle.set_flags(jprev)


@pytest.fixture()
def crash_hooks():
    """The crash hooks over a silenced default thread hook; both are
    process-wide, so both are put back."""
    prev_thr, prev_sys = threading.excepthook, sys.excepthook
    threading.excepthook = lambda args: None
    flight.install_crash_hooks()
    try:
        yield
    finally:
        flight.uninstall_crash_hooks()
        threading.excepthook, sys.excepthook = prev_thr, prev_sys


def _dumps_total(trigger):
    return om.default_registry().get(
        "observability.dumps_total").value(trigger=trigger)


def test_record_and_fields():
    flight.clear()
    flight.record("t", "ev", trace_id="abc", n=3)
    (e,) = flight.events(category="t")
    assert e["cat"] == "t" and e["name"] == "ev"
    assert e["trace_id"] == "abc" and e["attrs"] == {"n": 3}
    assert e["thread"] == threading.current_thread().name
    assert e["ts_us"] > 0
    assert flight.enabled()


def test_kill_switch():
    flight.clear()
    set_flags({"FLAGS_flight_recorder": 0})
    try:
        assert not flight.enabled()
        flight.record("t", "dropped")
        assert flight.events(category="t") == []
        assert flight.appended() == 0
    finally:
        set_flags({"FLAGS_flight_recorder": 1})
    flight.record("t", "kept")
    assert [e["name"] for e in flight.events(category="t")] == ["kept"]


def test_capacity_resize_keeps_the_newest_tail():
    """A capacity change rebuilds the ring at the next append, keeping
    its newest events; evicted events count as dropped."""
    prev = get_flags("FLAGS_flight_recorder_capacity")
    try:
        set_flags({"FLAGS_flight_recorder_capacity": 64})
        flight.clear()
        for i in range(50):
            flight.record("t", "e", i=i)
        set_flags({"FLAGS_flight_recorder_capacity": 32})
        for i in range(50, 100):
            flight.record("t", "e", i=i)
        evs = flight.events(category="t")
        assert [e["attrs"]["i"] for e in evs] == list(range(68, 100))
        assert flight.dropped() == 100 - 32
        assert flight.appended() == 100
        set_flags({"FLAGS_flight_recorder_capacity": 3})  # floor 16
        flight.record("t", "e", i=100)
        assert len(flight.events(category="t")) == 16
    finally:
        set_flags(prev)
        flight.record("t", "resize")
        flight.clear()


def test_filters_and_chrome_events():
    flight.clear()
    for i in range(6):
        flight.record("t", "e", trace_id=f"r{i % 2}", i=i)
    assert [e["attrs"]["i"] for e in flight.events(trace_id="r0")] == \
        [0, 2, 4]
    assert len(flight.events(n=2, category="t")) == 2
    flight.record("t", "mark", trace_id="x", k=1)
    ev = [e for e in flight.chrome_events() if e["name"] == "t.mark"][0]
    assert ev["ph"] == "i" and ev["s"] == "t" and ev["cat"] == "t"
    assert ev["args"] == {"k": 1, "trace_id": "x"}
    assert ev["pid"] == os.getpid()


def test_dump_roundtrip(dump_dir):
    flight.clear()
    flight.record("t", "one", trace_id="tr", a=1)
    flight.record("t", "two")
    before = _dumps_total("explicit")
    path = flight.dump(trigger="explicit", note="unit")
    assert path.startswith(dump_dir)
    assert os.path.basename(path).startswith(f"flight-{os.getpid()}-")
    assert flight.last_dump_path() == path
    header, evs = flight.load_dump(path)
    assert header["kind"] == "flight_header" and header["version"] == 1
    assert header["trigger"] == "explicit" and header["note"] == "unit"
    assert header["events"] == len(evs) == 2
    assert [e["name"] for e in evs] == ["one", "two"]
    assert evs[0]["trace_id"] == "tr" and evs[0]["attrs"] == {"a": 1}
    assert _dumps_total("explicit") == before + 1
    with open(path) as f:
        for line in f:
            json.loads(line)
    text = flight.render_events(evs, header)
    assert "trigger=explicit" in text and "t.one" in text
    assert "note=unit" in text and "[tr]" in text
    assert flight.render_events([]) == "<no events>"


def test_dump_lines_equal_the_jax_dump_of_the_same_ring(dump_dir):
    """The same events in both rings: the two dumps' event lines are
    equal byte for byte, and their headers hold the same keys. Each dump
    gets a path of its own: the default name is ``flight-<pid>-<seq>-
    <trigger>.jsonl`` in both packages, and their sequence counters are
    independent, so in one process the two defaults can coincide."""
    flight.clear()
    jflight.clear()
    flight.record("serving", "submit", trace_id="req-1", max_new=4)
    flight.record("supervisor", "loop_death", kind="crash",
                  error="KillPoint", streak=1, in_flight=2)
    flight.record("checkpoint", "save", path="x", bytes=10, dur_ms=1.5)
    for ev in list(flight._ring):
        jflight._ring.append(ev)
    t = flight.dump(os.path.join(dump_dir, "port.jsonl"),
                    trigger="supervisor")
    j = jflight.dump(os.path.join(dump_dir, "jax.jsonl"),
                     trigger="supervisor")
    with open(t) as ft, open(j) as fj:
        t_lines, j_lines = ft.read().splitlines(), fj.read().splitlines()
    assert t_lines[1:] == j_lines[1:] and len(t_lines) == 4
    th, jh = json.loads(t_lines[0]), json.loads(j_lines[0])
    # both name the chrome trace written beside the dump (the JAX one
    # only when its native tracer built)
    assert set(th) - {"chrome_trace"} == set(jh) - {"chrome_trace"}
    assert th["chrome_trace"] == "port.jsonl.trace.json"
    for k in ("kind", "version", "trigger", "events", "capacity"):
        assert th[k] == jh[k], k
    jflight.clear()


def test_dump_with_the_recorder_off_and_find_dumps(dump_dir):
    flight.clear()
    flight.record("t", "pre")
    set_flags({"FLAGS_flight_recorder": 0})
    try:
        p1 = flight.dump()
    finally:
        set_flags({"FLAGS_flight_recorder": 1})
    assert [e["name"] for e in flight.load_dump(p1)[1]] == ["pre"]
    time.sleep(0.02)
    p2 = flight.dump(trigger="explicit")
    found = flight.find_dumps(dump_dir)
    assert found[0] == p2 and p1 in found
    assert flight.dump_dir() == dump_dir
    assert flight.find_dumps(os.path.join(dump_dir, "missing")) == []


def test_cli_renders_a_dump_as_the_jax_cli_does(dump_dir, capsys):
    flight.clear()
    flight.record("cli", "seeded", trace_id="cli-1")
    flight.record("cli", "other", trace_id="cli-2")
    path = flight.dump()
    outs = []
    for cli in (tcli, jcli):
        assert cli.main(["--flight", path]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "cli.seeded" in outs[0] and "[cli-1]" in outs[0]
    assert tcli.main(["--flight", path, "--trace", "cli-1", "--json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert {e["trace_id"] for e in data["events"]} == {"cli-1"}
    assert tcli.main(["--flight", "--last", "1"]) == 0  # newest dump
    assert "cli.other" in capsys.readouterr().out
    assert tcli.main(["--flight", os.path.join(dump_dir, "nope")]) == 1


def test_cli_module_runs_without_jax(dump_dir):
    """``python -m paddle_tpu_torch.observability --flight`` in a fresh
    interpreter renders the newest dump and loads no JAX."""
    flight.clear()
    flight.record("cli", "subprocess", trace_id="s-1")
    flight.dump()
    code = ("import runpy, sys\n"
            "sys.argv = ['x', '--flight', '--trace', 's-1']\n"
            "try:\n"
            "    runpy.run_module('paddle_tpu_torch.observability',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'paddle_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               FLAGS_flight_dump_dir=dump_dir)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "cli.subprocess" in out.stdout and "[s-1]" in out.stdout


def test_thread_crash_dumps(dump_dir, crash_hooks):
    flight.clear()
    flight.record("t", "before_crash", probe=7)
    before = _dumps_total("exception")

    def boom():
        raise RuntimeError("seeded thread crash")

    t = threading.Thread(target=boom, name="boom")
    t.start()
    t.join(10)
    dumps = flight.find_dumps(dump_dir)
    assert dumps and _dumps_total("exception") == before + 1
    header, evs = flight.load_dump(dumps[0])
    assert header["trigger"] == "exception"
    assert "RuntimeError in thread boom" in header["note"]
    assert any(e["name"] == "before_crash" for e in evs)
    crash = [e for e in evs if e["cat"] == "crash"]
    assert crash[-1]["attrs"]["error"] == "RuntimeError"


def test_sys_excepthook_wrapper_dumps(dump_dir, crash_hooks):
    flight.clear()
    flight.record("t", "mainline_state")
    try:
        raise ValueError("seeded main-thread crash")
    except ValueError:
        tp, val, tb = sys.exc_info()
    prev = sys.__excepthook__
    try:
        sys.__excepthook__ = lambda *a: None
        sys.excepthook(tp, val, tb)
    finally:
        sys.__excepthook__ = prev
    header, evs = flight.load_dump(flight.find_dumps(dump_dir)[0])
    assert header["trigger"] == "exception"
    assert any(e["name"] == "mainline_state" for e in evs)


def test_signal_dump_and_uninstall_restores(dump_dir):
    """A bound signal writes a live dump and chains to the previous
    handler; uninstall puts back both hooks and the handler."""
    prev_sys, prev_thr = sys.excepthook, threading.excepthook
    seen = []

    def mine(signum, frame):
        seen.append(signum)

    prev_sig = signal.signal(signal.SIGUSR1, mine)
    try:
        flight.clear()
        flight.install_crash_hooks(signals=(signal.SIGUSR1,))
        flight.install_crash_hooks(signals=(signal.SIGUSR1,))  # idempotent
        assert sys.excepthook is not prev_sys
        assert threading.excepthook is not prev_thr
        os.kill(os.getpid(), signal.SIGUSR1)
        t_end = time.monotonic() + 10
        while not seen and time.monotonic() < t_end:
            time.sleep(0.01)
        assert seen == [signal.SIGUSR1]
        header, evs = flight.load_dump(flight.find_dumps(dump_dir)[0])
        assert header["trigger"] == "signal"
        assert evs[-1]["cat"] == "crash" and evs[-1]["name"] == "signal"
    finally:
        flight.uninstall_crash_hooks()
        handler = signal.getsignal(signal.SIGUSR1)
        signal.signal(signal.SIGUSR1, prev_sig)
    assert sys.excepthook is prev_sys
    assert threading.excepthook is prev_thr
    assert handler is mine
