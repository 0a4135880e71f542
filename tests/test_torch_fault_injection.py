"""Fault injection and backoff: the port's ``utils.fault_injection`` and
``utils.backoff`` against the JAX package's.

Each behaviour runs on both packages' modules (``skip``, ``times``,
``truncate_at``, ``injected``, ``stats``, kill-points, the transport
perturbations, ``FlakyStore`` over a dict store, ``kill_pid``), the
port's tally reaches its metrics snapshot, and ``full_jitter`` draws
the same sleeps as the JAX module's under ``seed(n)``.
"""
import os
import subprocess
import sys

import pytest

import paddle_tpu as paddle
from paddle_tpu.utils import backoff as jbackoff
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.utils import backoff as tbackoff
from paddle_tpu_torch.utils import fault_injection as tfi

MODULES = {"jax": jfi, "port": tfi}


@pytest.fixture(params=sorted(MODULES))
def fi(request):
    mod = MODULES[request.param]
    mod.clear()
    yield mod
    mod.clear()


def test_unarmed_sites_and_arming(fi):
    fi.fire("nothing.armed")
    assert not fi.armed("x")
    fi.inject("x", times=2)
    assert fi.armed("x")
    for _ in range(2):
        with pytest.raises(fi.InjectedFault):
            fi.fire("x")
    fi.fire("x")  # spent: disarmed
    assert not fi.armed("x")
    fi.inject("x")
    fi.clear("x")
    fi.fire("x")
    fi.inject("x", exc=ValueError("custom"))
    with pytest.raises(ValueError, match="custom"):
        fi.fire("x")


def test_skip_fails_the_nth_passage(fi):
    fi.inject("x", skip=2, times=1)
    fi.fire("x")
    fi.fire("x")
    with pytest.raises(fi.InjectedFault):
        fi.fire("x")
    fi.fire("x")


def test_kill_point_is_not_an_exception(fi):
    fi.inject("x", kill=True)
    with pytest.raises(fi.KillPoint, match="x"):
        try:
            fi.fire("x")
        except Exception:  # noqa: BLE001 — the point of the test
            pytest.fail("a KillPoint must not be caught as an Exception")
    assert issubclass(fi.InjectedFault, OSError)


def test_write_bytes_truncates(fi, tmp_path):
    """A truncation arm is left alone by fire() and consumed by
    write_bytes: the first N bytes land, then the armed error (or a
    kill) is raised. Unarmed, write_bytes writes the whole blob."""
    p = tmp_path / "f"
    fi.inject("w", truncate_at=3)
    fi.fire("w")  # not consumed here
    with open(p, "wb") as f:
        with pytest.raises(fi.InjectedFault, match="after 3 bytes"):
            fi.write_bytes("w", f, b"abcdef")
    assert p.read_bytes() == b"abc"
    fi.inject("w", truncate_at=4, kill=True)
    with open(p, "wb") as f:
        with pytest.raises(fi.KillPoint):
            fi.write_bytes("w", f, b"abcdef")
    assert p.read_bytes() == b"abcd"
    with open(p, "wb") as f:
        assert fi.write_bytes("w", f, b"abcdef") == 6
    assert p.read_bytes() == b"abcdef"


def test_injected_context_and_stats(fi):
    before = fi.stats().get("y", 0)
    with fi.injected("y", times=99):
        for _ in range(3):
            with pytest.raises(fi.InjectedFault):
                fi.fire("y")
    fi.fire("y")  # disarmed on exit
    assert fi.stats()["y"] == before + 3
    fi.clear()
    assert fi.stats()["y"] == before + 3  # survives clear()


def test_telemetry_collector():
    """The port's tally is a snapshot-time view in its registry."""
    tfi.clear()
    before = tfi.stats().get("telemetry.site", 0)
    tfi.inject("telemetry.site", times=2)
    for _ in range(2):
        with pytest.raises(tfi.InjectedFault):
            tfi.fire("telemetry.site")
    snap = om.snapshot()
    assert snap["faults"]["injected_total"]["telemetry.site"] == before + 2
    assert "faults_injected_total" in om.render_prometheus()


class _DictStore:
    def __init__(self):
        self.d = {}

    def set(self, k, v):
        self.d[k] = v

    def get(self, k):
        return self.d[k]

    def add(self, k, n):
        self.d[k] = self.d.get(k, 0) + n
        return self.d[k]

    name = "dict"


def test_flaky_store_over_a_dict_store(fi):
    st = fi.FlakyStore(_DictStore(), fail_times=2, ops=("add", "get"))
    for _ in range(2):
        with pytest.raises(ConnectionResetError, match="add"):
            st.add("c", 1)
    assert st.add("c", 5) == 5
    st.set("k", "v")  # not a flaky op
    for _ in range(2):
        with pytest.raises(ConnectionResetError):
            st.get("k")
    assert st.get("k") == "v"
    assert st.faults_fired == 4 and st.name == "dict"


class _Pipe:
    def __init__(self):
        self.sent, self.inbox = [], []

    def send(self, obj):
        self.sent.append(obj)

    def recv(self):
        return self.inbox.pop(0)

    def fileno(self):
        return 7


def test_flaky_transport(fi):
    """drop, duplicate and delay on sends and receives, after skip; an
    unarmed frame passes and other attributes pass through."""
    pipe = _Pipe()
    t = fi.FlakyTransport(pipe, "rpc")
    fi.inject_transport("rpc.send", drop=True, skip=1)
    t.send("a")
    t.send("b")  # dropped
    fi.inject_transport("rpc.send", duplicate=True, delay=0.001)
    t.send("c")
    t.send("d")
    assert pipe.sent == ["a", "c", "c", "d"]
    pipe.inbox = [1, 2, 3, 4]
    fi.inject_transport("rpc.recv", drop=True)
    assert t.recv() == 2  # 1 dropped
    fi.inject_transport("rpc.recv", duplicate=True)
    assert [t.recv(), t.recv(), t.recv()] == [3, 3, 4]
    assert t.fileno() == 7
    assert fi.stats()["rpc.send"] >= 2 and fi.stats()["rpc.recv"] >= 2


def test_kill_pid(fi):
    """Armed, kill_pid SIGKILLs the child; it never signals its own
    process; unarmed it is a no-op."""
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    try:
        assert fi.kill_pid("fleet.kill", child.pid) is False
        fi.inject("fleet.kill", times=2)
        assert fi.kill_pid("fleet.kill", os.getpid()) is False
        assert fi.kill_pid("fleet.kill", child.pid) is True
        assert child.wait(30) == -9
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(30)


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_full_jitter_draws_equal_the_jax_module(seed):
    """Under seed(n) both modules draw the same sleeps, each within
    [0, bound]; with the jitter off the bound comes back as it is."""
    bounds = [0.05, 0.1, 0.2, 0.4, 1.0, 2.0, 0.0, -1.0]
    tbackoff.seed(seed)
    jbackoff.seed(seed)
    got = [tbackoff.full_jitter(b) for b in bounds]
    assert got == [jbackoff.full_jitter(b) for b in bounds]
    assert all(0.0 <= g <= max(b, 0.0) for g, b in zip(got, bounds))
    assert got[-2:] == [0.0, 0.0]
    set_flags({"FLAGS_backoff_full_jitter": False})
    paddle.set_flags({"FLAGS_backoff_full_jitter": False})
    try:
        assert [tbackoff.full_jitter(b) for b in bounds] == \
            [jbackoff.full_jitter(b) for b in bounds] == \
            [0.05, 0.1, 0.2, 0.4, 1.0, 2.0, 0.0, 0.0]
    finally:
        set_flags({"FLAGS_backoff_full_jitter": True})
        paddle.set_flags({"FLAGS_backoff_full_jitter": True})


def test_site_tables_are_per_package():
    """Arming one package's site leaves the other's unarmed (each
    package has its own table)."""
    tfi.clear()
    jfi.clear()
    tfi.inject("serving.decode", kill=True)
    try:
        jfi.fire("serving.decode")
        assert tfi.armed("serving.decode")
        assert not jfi.armed("serving.decode")
    finally:
        tfi.clear()
