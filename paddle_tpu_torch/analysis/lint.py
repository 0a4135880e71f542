"""Source linter: an AST rule engine (stdlib ``ast`` only) with
repo-specific rules for the hazards this codebase has actually hit.

The port of ``paddle_tpu/analysis/lint.py``, over ``paddle_tpu_torch/``.

Rules (ids + defaults in ``analysis.diagnostics.RULES``):

- **PTL001** — implicit host sync in library code: ``.numpy()`` /
  ``.item()`` / ``.tolist()`` / ``.cpu()`` calls inside
  ``paddle_tpu_torch/``, on a Tensor or a raw torch tensor. Each is a
  device→host round trip on the card, and none can run inside a CUDA
  graph. Deliberate syncs (host-static structure, the host-interop API
  itself, the one read a decode step makes) are allowlisted with a
  justification.
- **PTL002** — registered flag never read: a ``define_flag`` whose name
  is read nowhere (``_registry[...]`` / ``flag_value(...)`` /
  ``get_flags``): dead surface, or a documented behavior that silently
  doesn't exist (the state ``FLAGS_benchmark`` and
  ``FLAGS_retain_grad_for_all_tensor`` were in until this linter).
- **PTL003** — unguarded global registry mutation: a structural
  mutation (``del``/``pop``/``popitem``/``clear``) of a module-level
  container inside a function with no enclosing ``with <lock>``.
  Single-assignment memo inserts are GIL-atomic and not flagged; the
  sweep-while-iterate patterns this rule exists for are not.
- **PTL004** — bare ``except:``: swallows KeyboardInterrupt/SystemExit
  and the fault-injection harness's BaseException kill-points.
- **PTL005** — ops.yaml ``fusable`` marker inconsistent with the live
  fusion impl registries. It waits for ``core/fusion.py``, which the
  port does not have (CUDA graphs do the lazy-fusion engine's job), so
  it does not run here.

Suppression is explicit and justified, never global: a checked-in
allowlist (``analysis/allowlist.py``) of (rule, path-glob, reason)
entries, plus inline ``# lint-allow: PTLxxx reason`` pragmas for
single sites. Suppressed findings are counted and reported, not
discarded silently.
"""
from __future__ import annotations

import ast
import fnmatch
import os
from typing import Dict, List, Optional, Set, Tuple

from .diagnostics import Diagnostic, sort_diagnostics

__all__ = ["lint", "LintResult", "iter_source_files", "REPO_ROOT"]

_HERE = os.path.dirname(os.path.abspath(__file__))
PKG_ROOT = os.path.dirname(_HERE)                    # .../paddle_tpu_torch
REPO_ROOT = os.path.dirname(PKG_ROOT)

_MUTABLE_CTORS = {"dict", "list", "set", "OrderedDict", "defaultdict",
                  "deque", "WeakValueDictionary", "WeakKeyDictionary"}
_STRUCTURAL_MUTATORS = {"clear", "pop", "popitem"}
_SYNC_ATTRS = {"numpy", "item", "tolist", "cpu"}


def iter_source_files(root: Optional[str] = None) -> List[str]:
    """Every .py file under the package (default: paddle_tpu_torch/)."""
    root = root or PKG_ROOT
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        for name in sorted(filenames):
            if name.endswith(".py"):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def _rel(path: str) -> str:
    p = os.path.abspath(path).replace("\\", "/")
    root = REPO_ROOT.replace("\\", "/") + "/"
    return p[len(root):] if p.startswith(root) else p


def _terminal_name(node) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _expr_mentions_lock(node) -> bool:
    for sub in ast.walk(node):
        n = None
        if isinstance(sub, ast.Name):
            n = sub.id
        elif isinstance(sub, ast.Attribute):
            n = sub.attr
        if n is not None and "lock" in n.lower():
            return True
    return False


class _FileVisitor(ast.NodeVisitor):
    """One pass per file. Collects per-file findings and the cross-file
    facts (flag defines/reads) the repo-level rules need."""

    def __init__(self, relpath: str, facts: "RepoFacts"):
        self.relpath = relpath
        self.facts = facts
        self.diags: List[Diagnostic] = []
        self._module_mutables: Set[str] = set()
        self._with_lock_depth = 0
        self._func_depth = 0
        self._collect_module_mutables_done = False

    # -- helpers ---------------------------------------------------------
    def _loc(self, node) -> str:
        return f"{self.relpath}:{node.lineno}"

    def _collect_module_mutables(self, tree: ast.Module) -> None:
        for stmt in tree.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            is_mut = isinstance(value, (ast.Dict, ast.List, ast.Set))
            if not is_mut and isinstance(value, ast.Call):
                is_mut = _terminal_name(value.func) in _MUTABLE_CTORS
            if not is_mut:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    self._module_mutables.add(t.id)

    # -- traversal -------------------------------------------------------
    def visit_Module(self, node):
        self._collect_module_mutables(node)
        self.generic_visit(node)

    def visit_With(self, node):
        locked = any(_expr_mentions_lock(item.context_expr)
                     for item in node.items)
        if locked:
            self._with_lock_depth += 1
        self.generic_visit(node)
        if locked:
            self._with_lock_depth -= 1

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node):
        self._func_depth += 1
        self.generic_visit(node)
        self._func_depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ExceptHandler(self, node):
        if node.type is None:
            self.diags.append(Diagnostic(
                "PTL004", self._loc(node),
                "bare `except:` — also catches KeyboardInterrupt/"
                "SystemExit and fault-injection kill-points",
                hint="catch Exception (or the specific error); bare "
                     "handlers around device code absorb injected "
                     "crashes the tests rely on"))
        self.generic_visit(node)

    def visit_Delete(self, node):
        if self._func_depth and not self._with_lock_depth:
            for t in node.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id in self._module_mutables:
                    self.diags.append(Diagnostic(
                        "PTL003", self._loc(node),
                        f"del on module-level registry "
                        f"`{t.value.id}` outside any lock",
                        hint="guard the sweep with the module's lock, "
                             "or justify the lock-free design in the "
                             "allowlist"))
        self.generic_visit(node)

    def visit_Call(self, node):
        func = node.func
        # PTL001: host-sync attribute calls
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_ATTRS \
                and not node.args and not node.keywords:
            recv_ok = True
            if func.attr in ("item", "tolist", "cpu"):
                recv = func.value
                if isinstance(recv, ast.Call):
                    # np.<fn>(...).item() is host->host numpy — but a
                    # chained device call (loss.mean().item()) is still
                    # a sync and must not slip through
                    f = recv.func
                    numpy_recv = (isinstance(f, ast.Attribute)
                                  and isinstance(f.value, ast.Name)
                                  and f.value.id in ("np", "numpy"))
                    recv_ok = not numpy_recv and _terminal_name(f) \
                        not in ("asarray", "array")
                else:
                    recv_ok = isinstance(recv, (ast.Name, ast.Attribute))
            if recv_ok:
                self.diags.append(Diagnostic(
                    "PTL001", self._loc(node),
                    f".{func.attr}() — implicit device->host sync in "
                    f"library code",
                    hint="keep the value on device, or allowlist with "
                         "a justification if the sync is the API "
                         "contract (host-static structural args, host "
                         "interop)"))
        # PTL003: structural mutators on module registries
        if isinstance(func, ast.Attribute) and \
                func.attr in _STRUCTURAL_MUTATORS and \
                isinstance(func.value, ast.Name) and \
                func.value.id in self._module_mutables and \
                self._func_depth and not self._with_lock_depth:
            self.diags.append(Diagnostic(
                "PTL003", self._loc(node),
                f"`{func.value.id}.{func.attr}()` on a module-level "
                f"registry outside any lock",
                hint="guard with the module's lock, or justify the "
                     "lock-free design in the allowlist"))
        # flag facts
        fname = _terminal_name(func)
        if fname == "define_flag" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            self.facts.flag_defines.setdefault(
                node.args[0].value, self._loc(node))
        elif fname == "flag_value" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            self.facts.flag_reads.add(node.args[0].value)
        elif fname == "get_flags":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Constant) and \
                        isinstance(sub.value, str):
                    name = sub.value
                    if name.startswith("FLAGS_"):
                        name = name[len("FLAGS_"):]
                    self.facts.flag_reads.add(name)
        self.generic_visit(node)

    def visit_Subscript(self, node):
        # _registry["name"] / _flag_registry["name"] reads
        base = _terminal_name(node.value)
        if base is not None and "registry" in base:
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                self.facts.flag_reads.add(sl.value)
        self.generic_visit(node)


class RepoFacts:
    def __init__(self):
        self.flag_defines: Dict[str, str] = {}   # name -> define loc
        self.flag_reads: Set[str] = set()


class LintResult:
    def __init__(self):
        self.diagnostics: List[Diagnostic] = []
        self.suppressed: List[Tuple[Diagnostic, str]] = []
        self.files_scanned = 0
        self.parse_errors: List[str] = []

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def render(self) -> str:
        lines = [f"lint: {self.files_scanned} files, "
                 f"{len(self.diagnostics)} finding(s), "
                 f"{len(self.suppressed)} allowlisted"]
        for d in self.diagnostics:
            lines.append(d.render())
        if self.suppressed:
            lines.append("  allowlisted (rule @ location — justification):")
            for d, why in self.suppressed:
                lines.append(f"    {d.rule} @ {d.location} — {why}")
        if self.parse_errors:
            lines.append("  parse errors: " + "; ".join(self.parse_errors))
        return "\n".join(lines)


def allowlist_reason(d: Diagnostic, entries) -> Optional[str]:
    """The ONE suppression-matching rule (shared by the linter and the
    capture pass): an entry ``(rule, pattern, reason)`` suppresses a
    diagnostic when the rule matches and the fnmatch pattern hits the
    file path, the full ``path:line`` location, or the message."""
    path = d.location.partition(":")[0]
    for rule, pattern, reason in entries:
        if rule == d.rule and (fnmatch.fnmatch(path, pattern)
                               or fnmatch.fnmatch(d.location, pattern)
                               or fnmatch.fnmatch(d.message, pattern)):
            return reason
    return None


def _pragmas(source: str) -> Dict[int, Set[str]]:
    """line -> {rule ids} from inline `# lint-allow: PTLxxx reason`."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), 1):
        marker = "# lint-allow:"
        pos = line.find(marker)
        if pos < 0:
            continue
        rules = {tok.strip().rstrip(",")
                 for tok in line[pos + len(marker):].split()
                 if tok.strip().rstrip(",").startswith(("PTL", "PTA",
                                                        "PTK", "PTC"))}
        if rules:
            out[i] = rules
    return out


def lint_source(source: str, name: str = "<snippet>") -> List[Diagnostic]:
    """Run the per-file AST rules over a source string (no allowlist,
    no cross-file rules) — the seeded-bug fixture entry point for tests
    and ``--self-check``."""
    tree = ast.parse(source, filename=name)
    visitor = _FileVisitor(name, RepoFacts())
    visitor.visit(tree)
    return sort_diagnostics(visitor.diags)


def lint(paths: Optional[List[str]] = None,
         use_allowlist: bool = True) -> LintResult:
    """Lint ``paths`` (default: every .py under paddle_tpu_torch/) and return
    a :class:`LintResult`. Allowlist + pragma suppressions are applied
    (and reported) unless ``use_allowlist=False`` — the seeded-bug
    tests turn it off to see raw findings."""
    result = LintResult()
    facts = RepoFacts()
    files = paths if paths is not None else iter_source_files()
    raw: List[Diagnostic] = []
    pragma_map: Dict[str, Dict[int, Set[str]]] = {}
    for path in files:
        rel = _rel(path)
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError) as e:
            result.parse_errors.append(f"{rel}: {e}")
            continue
        result.files_scanned += 1
        pragma_map[rel] = _pragmas(source)
        visitor = _FileVisitor(rel, facts)
        visitor.visit(tree)
        raw.extend(visitor.diags)

    # cross-file: PTL002 (only meaningful on a whole-package scan —
    # a partial path list would see defines without their reads)
    if paths is None:
        for name, loc in sorted(facts.flag_defines.items()):
            if name not in facts.flag_reads:
                raw.append(Diagnostic(
                    "PTL002", loc,
                    f"FLAGS_{name} is registered but read nowhere in "
                    f"paddle_tpu_torch/ — either dead surface or documented "
                    f"behavior that silently does nothing",
                    hint="wire the flag where its docs claim it acts, "
                         "or allowlist it as deliberate reference-"
                         "parity surface"))

    # suppression: inline pragmas, then the checked-in allowlist
    allow_entries: List[Tuple[str, str, str]] = []
    if use_allowlist:
        from .allowlist import ALLOWLIST
        allow_entries = list(ALLOWLIST)
    for d in raw:
        path, _, lineno = d.location.partition(":")
        line = int(lineno) if lineno.isdigit() else -1
        rules_here = pragma_map.get(path, {}).get(line, ())
        if use_allowlist and d.rule in rules_here:
            result.suppressed.append((d, "inline pragma"))
            continue
        why = allowlist_reason(d, allow_entries)
        if why is not None:
            result.suppressed.append((d, why))
        else:
            result.diagnostics.append(d)
    result.diagnostics = sort_diagnostics(result.diagnostics)

    try:
        from ..observability import metrics as _om
        _om.counter("analysis.lint_runs_total",
                    "Source-linter runs").inc()
        cd = _om.counter(
            "analysis.diagnostics_total",
            "Diagnostics emitted by the analysis plane, by rule")
        for d in result.diagnostics:
            cd.inc(rule=d.rule)
    except Exception:  # noqa: BLE001 — lint must work standalone
        pass
    return result
