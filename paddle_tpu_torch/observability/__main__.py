"""``python -m paddle_tpu_torch.observability`` — telemetry + flight CLI.

The port's copy of ``paddle_tpu.observability.__main__``. Default:
print the process metrics snapshot as JSON (mostly useful from an
embedding process; a fresh CLI process has nothing hot).

Options:
  --flight [path]  render a flight-recorder dump as a readable event
                   trail (the crash-forensics reading surface). With no
                   path, the newest ``flight-*.jsonl`` in the dump dir
                   (FLAGS_flight_dump_dir, default system temp) is
                   used; if none exists the live in-process ring is
                   shown instead.
  --trace ID       filter --flight output to one request's trace_id
  --last N         only the last N events
  --json           emit JSON instead of text
"""
from __future__ import annotations

import json
import sys


def _flight_path(argv) -> object:
    """The operand following --flight, or None."""
    i = argv.index("--flight")
    for a in argv[i + 1:]:
        if not a.startswith("--"):
            return a
        break
    return None


def _opt(argv, name):
    if name in argv:
        i = argv.index(name)
        if i + 1 < len(argv):
            return argv[i + 1]
    return None


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--flight" in argv:
        from . import flight
        path = _flight_path(argv)
        trace = _opt(argv, "--trace")
        last = _opt(argv, "--last")
        header, evs = {}, []
        if path is None:
            dumps = flight.find_dumps()
            if dumps:
                path = dumps[0]
        if path is not None:
            try:
                header, evs = flight.load_dump(path)
            except (OSError, ValueError) as e:
                print(f"cannot read flight dump {path!r}: {e}",
                      file=sys.stderr)
                return 1
        else:
            evs = flight.events()
            header = {"trigger": "<live ring>", "events": len(evs),
                      "dropped": flight.dropped(),
                      "capacity": flight._capacity()}
        if trace is not None:
            evs = [e for e in evs if e.get("trace_id") == trace]
        if last is not None:
            evs = evs[-int(last):]
        if "--json" in argv:
            print(json.dumps({"header": header, "events": evs},
                             indent=2, default=str))
        else:
            if path is not None:
                print(f"# {path}")
            print(flight.render_events(evs, header))
        return 0
    from .metrics import snapshot
    print(json.dumps(snapshot(), indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
