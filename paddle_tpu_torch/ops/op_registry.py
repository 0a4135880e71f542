"""The port's op table: ``ops.yaml`` loaded into a Python registry.

The counterpart of ``paddle_tpu.ops.op_registry`` without its native
C++ mirror: :data:`OP_TABLE` maps each op name to its descriptor
(module, arity, vjp, SPMD rule, variadic, fusion class, shape spec).
A row's ``module`` is under ``paddle_tpu_torch.ops`` when it is a bare
name (``math``) and under ``paddle_tpu_torch`` when dotted
(``nn.functional``). :func:`resolve` finds an op's function in the
port, :func:`unported` lists the rows whose module or function the
port does not have yet (they are queued, not dropped), and
:func:`dispatch_counts` the eager dispatches per op name.
"""
from __future__ import annotations

import importlib
import os
import re
from typing import Callable, Dict, List, Optional

__all__ = ["OP_TABLE", "get_op_info", "list_ops", "num_ops", "resolve",
           "unported", "dispatch_counts"]

_HERE = os.path.dirname(os.path.abspath(__file__))

OP_TABLE: Dict[str, dict] = {}

# YAML 1.1 scalars as PyYAML's SafeLoader resolves them, for a machine
# without PyYAML (the table is a flat list of mappings)
_YAML_BOOLS = {}
for _w, _b in (("yes", True), ("no", False), ("true", True),
               ("false", False), ("on", True), ("off", False)):
    for _form in (_w, _w.capitalize(), _w.upper()):
        _YAML_BOOLS[_form] = _b
_YAML_NULLS = {"", "~", "null", "Null", "NULL"}
_YAML_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")


def _parse_scalar(v: str):
    if len(v) >= 2 and v[0] == v[-1] and v[0] in ("'", '"'):
        return v[1:-1]
    if v in _YAML_NULLS:
        return None
    if v in _YAML_BOOLS:
        return _YAML_BOOLS[v]
    if _YAML_INT.match(v):
        return int(v.replace("_", ""))
    return v


def _parse_yaml_fallback(text: str) -> list:
    ops, cur = [], None
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("#") or not s:
            continue
        if s.startswith("- name:"):
            cur = {"name": _parse_scalar(s.split(":", 1)[1].strip())}
            ops.append(cur)
        elif cur is not None and ":" in s and s != "ops:":
            k, v = s.split(":", 1)
            cur[k.strip()] = _parse_scalar(v.strip())
    return ops


def _load_yaml() -> list:
    with open(os.path.join(_HERE, "ops.yaml")) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return _parse_yaml_fallback(text)
    return yaml.safe_load(text)["ops"]


def _register_all():
    for entry in _load_yaml():
        OP_TABLE[entry["name"]] = {
            "module": entry.get("module", ""),
            "nin": int(entry.get("nin", 1)),
            "nargs": int(entry.get("nargs", 1)),
            "has_vjp": bool(entry.get("vjp", True)),
            "spmd_rule": entry.get("spmd", "") or "",
            "variadic": bool(entry.get("variadic", False)),
            "fusable": entry.get("fusable", False) or False,
            "shape_spec": entry.get("shape"),
        }


def get_op_info(name: str) -> Optional[dict]:
    return OP_TABLE.get(name)


def list_ops() -> List[str]:
    return sorted(OP_TABLE)


def num_ops() -> int:
    return len(OP_TABLE)


def _module_path(module: str) -> str:
    pkg = __name__.rsplit(".", 2)[0]
    return f"{pkg}.{module}" if "." in module else f"{pkg}.ops.{module}"


def resolve(name: str) -> Optional[Callable]:
    """The port's function for op ``name``, or None when its module or
    the function is not ported."""
    info = OP_TABLE.get(name)
    if info is None:
        return None
    try:
        mod = importlib.import_module(_module_path(info["module"]))
    except ImportError:
        return None
    return getattr(mod, name, None)


def unported() -> List[str]:
    """The op names whose module or function the port lacks."""
    return sorted(n for n in OP_TABLE if resolve(n) is None)


def dispatch_counts() -> Dict[str, int]:
    """Eager dispatches per op name since process start, as
    ``core.autograd.apply_op`` counts them."""
    from ..core.autograd import _dispatches
    return dict(_dispatches)


_register_all()
