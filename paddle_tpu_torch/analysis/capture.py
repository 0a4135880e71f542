"""Static graph-break analysis: prove, before tracing, where a step
function can and cannot become one captured program.

The port of ``paddle_tpu/analysis/capture.py``: the same rules over the
same taint analysis, with the torch spellings added (``torch.*`` calls
make tensors, ``.cpu()`` is a host read). The dynamic auditor reports
breaks on paths a run actually executed; this pass (stdlib ``ast``, the
``analysis/lint.py`` engine style) reads the step function's SOURCE,
so it also sees the branches a recording never took. In the port a
captured program is a CUDA graph (``CapturedStep``, an SOT segment,
``capture_jit``).

Rules (ids + defaults in ``analysis.diagnostics.RULES``):

- **PTC001** — data-dependent control flow on tensor values: ``if t:``,
  ``while t.item():``, tensor-valued comparisons/``bool()`` feeding a
  branch. Each taken branch is a guard + graph break at capture time.
  Shape/ndim/dtype reads are static metadata, never flagged.
- **PTC002** — capture-poisoning side effects: in-place tensor
  mutation (``t[i] = v``, ``zero_()``-family methods), RNG consumption,
  mutation of ``self``/module/global state (``.append`` on persistent
  containers, augmented assignment to ``self`` attributes), host I/O
  (``print``/``open``). ``jit/sot.py`` marks these non-replayable at
  runtime; this flags them ahead of time.
- **PTC003** — host reads (``.item()``/``.numpy()``/``.tolist()``/
  ``.cpu()``/``float(t)``/``np.asarray(t)``). A read that postdominates all device
  work in the function is HOISTABLE (fix hint: move after the step);
  a mid-step read must become a capture guard or move.
- **PTC004** — statically visible shape polymorphism: boolean-mask
  indexing and ``nonzero``/``unique``/``masked_select`` calls, whose
  output shapes are data-dependent. (The planner adds the dynamic
  cross-check: PTA003 churn rows become PTC004 entries with a
  BucketPolicy hint.)

Tensor values are tracked by monotonic may-taint: seeds are calls into
tensor-producing modules (``paddle``/``jnp``/``jax``/``F``), known
factories (``to_tensor`` and friends) and tensor parameters (explicit,
or a live callable's defaultless positional args); taint flows through
arithmetic, method calls, container literals and unpacking, and — once
a name has held device-derived data — never retracts (a branch on a
re-bound host value is still data-dependent control flow: the fetch
was the sync, the branch is the guard). Host-read RESULTS start
untainted. Conservatism is otherwise toward NOT flagging — the
planner's zero-false-positive contract on clean jittable steps
outranks recall, because the dynamic audit backstops anything the
static pass misses on executed paths.

Suppression mirrors the linter: ``analysis/allowlist.py``'s
``CAPTURE_ALLOWLIST`` (rule, glob, justification — stale entries fail
tests) or inline ``# lint-allow: PTC00x reason`` pragmas.
"""
from __future__ import annotations

import ast
import os
import textwrap
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .diagnostics import Diagnostic, sort_diagnostics
from .lint import REPO_ROOT, _pragmas, _rel, _terminal_name

__all__ = ["capture_scan", "scan_source", "scan_file_function",
           "scan_repo_steps", "enclosing_function_scan", "REPO_STEPS",
           "CaptureScanResult"]

# modules whose calls produce device tensors
_TENSOR_MODULES = {"paddle", "paddle_tpu", "paddle_tpu_torch", "torch",
                   "jnp", "jax", "F", "TF", "functional", "nn", "lax"}
# bare-name calls that produce tensors
_TENSOR_FACTORIES = {"to_tensor", "_to_tensor", "zeros", "ones", "full",
                     "arange", "linspace", "eye", "empty", "zeros_like",
                     "ones_like", "full_like", "asarray"}
# BARE-NAME builtin calls whose results are never tensors even with
# tensor args (attribute calls like t.sum()/paddle.max() are exempt —
# they are tensor ops sharing a builtin's name)
_NON_TENSOR_CALLS = {"isinstance", "len", "type", "range", "enumerate",
                     "zip", "sorted", "list", "tuple", "dict", "set",
                     "getattr", "hasattr", "repr", "str", "id", "print",
                     "min", "max", "sum", "abs", "issubclass", "iter"}
# host-metadata attributes: reading them is static, not a device read
_METADATA_ATTRS = {"shape", "ndim", "dtype", "size", "name", "place",
                   "stop_gradient", "trainable", "training", "is_leaf"}
# device->host conversion methods (the sync surface, PTL001's set)
_HOST_READS = {"item", "numpy", "tolist", "cpu"}
# host scalar converters: float(t)/int(t)/bool(t) on a tensor sync
_SCALAR_CONVERTERS = {"float", "int", "bool"}
# in-place tensor mutators (ops/inplace.py surface + setters); the
# generic rule also catches `meth_()` with a tainted receiver
_INPLACE_METHODS = {"set_value", "fill_", "zero_", "add_", "subtract_",
                    "multiply_", "divide_", "scale_", "clip_", "copy_",
                    "exponential_", "uniform_", "normal_", "scatter_",
                    "squeeze_", "unsqueeze_", "reshape_", "flatten_",
                    "clear_gradient"}
# device RNG consumers (replay cannot reproduce the key stream)
_RNG_CALLS = {"dropout", "rand", "randn", "randint", "randperm",
              "uniform", "normal", "standard_normal", "bernoulli",
              "multinomial", "poisson", "rand_like", "randn_like",
              "randint_like", "dropout2d", "dropout3d", "alpha_dropout"}
# data-dependent-shape producers (PTC004)
_DYNSHAPE_CALLS = {"nonzero", "masked_select", "unique",
                   "index_select_dynamic"}
# persistent-container mutators (PTC002 when the receiver persists
# beyond the step: self attributes, globals)
_CONTAINER_MUTATORS = {"append", "extend", "update", "add",
                       "setdefault", "pop", "clear", "insert", "remove"}


def _root_name(node) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_self_attr(node) -> bool:
    return (isinstance(node, ast.Attribute)
            and _root_name(node) == "self")


class _FnScanner(ast.NodeVisitor):
    """Scans ONE function definition. Run ``visit`` twice: pass 1 grows
    the taint set to fixpoint across loops, pass 2 (``collect=True``)
    records events and findings."""

    def __init__(self, relpath: str, tensor_params: Sequence[str] = ()):
        self.relpath = relpath
        self.tainted: Set[str] = set(tensor_params)
        # names bound to tensor-valued COMPARISONS (boolean masks):
        # only these make indexing shape-dynamic — an integer-tensor
        # gather has the index's static shape
        self.masks: Set[str] = set()
        self.globals_declared: Set[str] = set()
        self.collect = False
        self.diags: List[Diagnostic] = []
        self.device_lines: List[int] = []
        self.syncs: List[Tuple[int, str, ast.AST]] = []
        self.branch_lines: Set[int] = set()
        self.loop_spans: List[Tuple[int, int]] = []
        self._depth = 0

    # -- taint oracle ----------------------------------------------------
    def is_tensor(self, node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _METADATA_ATTRS:
                return False
            return self.is_tensor(node.value)
        if isinstance(node, ast.Call):
            return self._call_is_tensor(node)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False  # identity/membership, not a value compare
            return self.is_tensor(node.left) or \
                any(self.is_tensor(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tensor(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, (ast.List, ast.Tuple)):
            return any(self.is_tensor(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.is_tensor(node.value)
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            return self.is_tensor(node.elt)
        if isinstance(node, ast.Await):
            return self.is_tensor(node.value)
        return False

    def _call_is_tensor(self, node: ast.Call) -> bool:
        func = node.func
        name = _terminal_name(func)
        # the builtin exclusion applies to BARE calls only: t.sum() /
        # t.abs() / paddle.max(t) are tensor ops sharing a builtin's
        # name, and untainting them would hide their branches
        if isinstance(func, ast.Name) and (
                name in _NON_TENSOR_CALLS or name in _SCALAR_CONVERTERS):
            return False
        if name in _HOST_READS:
            return False
        root = _root_name(func) if isinstance(func, ast.Attribute) else None
        if name in ("asarray", "array") and root in ("np", "numpy"):
            return False  # host conversion: the result left the device
        if name in _TENSOR_FACTORIES:
            return True
        if root in _TENSOR_MODULES:
            return True
        if isinstance(func, ast.Attribute) and self.is_tensor(func.value):
            return True  # method on a tensor
        # tensor-in -> tensor-out assumption for opaque callables
        # (self.network(*ins), a step closure, a loss module)
        return any(self.is_tensor(a) for a in node.args) or \
            any(self.is_tensor(kw.value) for kw in node.keywords)

    def _is_mask(self, node) -> bool:
        if isinstance(node, ast.Compare):
            return self.is_tensor(node)
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.UnaryOp):
            return self._is_mask(node.operand)       # ~mask
        if isinstance(node, ast.BinOp):
            return self._is_mask(node.left) or \
                self._is_mask(node.right)            # mask & mask
        return False

    def _taint_target(self, target, tensor: bool, mask: bool = False):
        # MAY-taint, monotonic: once a name has held tensor-derived
        # data it stays tainted — the fixpoint pass re-walks the body,
        # so a kill here would let loop headers (`a = 0` before a loop
        # that re-taints `a`) erase loop-carried taint every pass. A
        # later branch on a re-bound host value is still data-dependent
        # control flow on device data (the fetch was the sync, the
        # branch is the guard), so never-discarding is also the
        # semantically honest reading.
        if isinstance(target, ast.Name):
            if tensor:
                self.tainted.add(target.id)
            if mask:
                self.masks.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._taint_target(e, tensor)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value, tensor)
        # attribute/subscript targets don't enter the local taint set

    # -- event recording -------------------------------------------------
    def _note_device(self, node):
        if self.collect:
            self.device_lines.append(getattr(node, "lineno", 0))

    def _note_sync(self, node, kind: str):
        if self.collect:
            self.syncs.append((node.lineno, kind, node))

    def _diag(self, rule, node, msg, hint=""):
        if self.collect:
            self.diags.append(Diagnostic(
                rule, f"{self.relpath}:{node.lineno}", msg, hint=hint))

    # -- statements ------------------------------------------------------
    def visit_Global(self, node):
        self.globals_declared.update(node.names)

    def visit_Assign(self, node):
        self.generic_visit(node)
        tensor = self.is_tensor(node.value)
        mask = self._is_mask(node.value)
        for t in node.targets:
            self._taint_target(t, tensor, mask)
            if isinstance(t, ast.Subscript):
                base = t.value
                if self.is_tensor(base):
                    self._diag(
                        "PTC002", node,
                        "in-place tensor mutation (subscript store) "
                        "inside the candidate capture region",
                        hint="replay cannot reproduce buffer mutation "
                             "— rebuild the value functionally "
                             "(where/scatter) or cut the region here")
                elif _is_self_attr(base):
                    self._diag(
                        "PTC002", node,
                        f"subscript store on persistent state "
                        f"`{ast.unparse(base)}` inside the step",
                        hint="state mutated mid-step never replays; "
                             "move bookkeeping to the step boundary")
            elif isinstance(t, ast.Name) and t.id in self.globals_declared:
                self._diag(
                    "PTC002", node,
                    f"assignment to global `{t.id}` inside the step",
                    hint="global writes are silently skipped on "
                         "replay; return the value instead")

    def visit_AnnAssign(self, node):
        self.generic_visit(node)
        if node.value is not None:
            self._taint_target(node.target, self.is_tensor(node.value))

    def visit_AugAssign(self, node):
        self.generic_visit(node)
        t = node.target
        base = t.value if isinstance(t, ast.Subscript) else t
        if isinstance(t, ast.Subscript) and self.is_tensor(t.value):
            self._diag(
                "PTC002", node,
                "in-place tensor mutation (augmented subscript store)",
                hint="rebuild the value functionally or cut the "
                     "capture region here")
        elif _is_self_attr(base):
            self._diag(
                "PTC002", node,
                f"augmented assignment to persistent state "
                f"`{ast.unparse(base)}` inside the step",
                hint="state mutated mid-step never replays; move "
                     "bookkeeping to the step boundary")
        elif isinstance(t, ast.Name):
            if self.is_tensor(node.value) or t.id in self.tainted:
                self.tainted.add(t.id)
                self._note_device(node)

    def visit_For(self, node):
        if self.collect:
            self.loop_spans.append(
                (node.lineno, getattr(node, "end_lineno", node.lineno)))
        self._taint_target(node.target, self.is_tensor(node.iter))
        self.generic_visit(node)

    def visit_While(self, node):
        if self.collect:
            self.loop_spans.append(
                (node.lineno, getattr(node, "end_lineno", node.lineno)))
        self._check_branch(node, "while")
        self.generic_visit(node)

    def visit_If(self, node):
        self._check_branch(node, "if")
        self.generic_visit(node)

    def _check_branch(self, node, kw: str):
        test = node.test
        # a host read feeding the test IS the data dependence, whether
        # spelled .item()/.numpy() or float(t)/bool(t)/int(t)
        reads = []
        for n in ast.walk(test):
            if not isinstance(n, ast.Call):
                continue
            name = _terminal_name(n.func)
            if name in _HOST_READS:
                reads.append(name)
            elif isinstance(n.func, ast.Name) and \
                    name in _SCALAR_CONVERTERS and len(n.args) == 1 \
                    and self.is_tensor(n.args[0]):
                reads.append(name)
        if reads or self.is_tensor(test):
            via = (f"via {reads[0]}()" if reads
                   else "on a tensor value")
            self._diag(
                "PTC001", node,
                f"data-dependent `{kw}` {via}: each taken branch "
                f"becomes a guard + graph break under whole-step "
                f"capture",
                hint="hoist the decision out of the step, rewrite as "
                     "a masked/where computation, or accept one "
                     "compiled path per branch outcome (SOT guard)")
            self.branch_lines.add(node.lineno)

    # -- calls -----------------------------------------------------------
    def visit_Call(self, node):
        self.generic_visit(node)
        func = node.func
        name = _terminal_name(func)
        # host reads: .item()/.numpy()/.tolist() (PTL001's receiver
        # heuristic: skip np.* host->host chains)
        if isinstance(func, ast.Attribute) and name in _HOST_READS \
                and not node.args and not node.keywords:
            recv = func.value
            recv_ok = True
            if isinstance(recv, ast.Call):
                root = _root_name(recv.func)
                recv_ok = root not in ("np", "numpy") and \
                    _terminal_name(recv.func) not in ("asarray", "array")
            elif not isinstance(recv, (ast.Name, ast.Attribute,
                                       ast.Subscript)):
                recv_ok = False
            if recv_ok:
                self._note_sync(node, f".{name}()")
        # float(t)/int(t)/bool(t) and np.asarray(t) on tainted values
        elif isinstance(func, ast.Name) and name in _SCALAR_CONVERTERS \
                and len(node.args) == 1 and self.is_tensor(node.args[0]):
            self._note_sync(node, f"{name}()")
        elif name in ("asarray", "array") and \
                _root_name(func) in ("np", "numpy") and node.args and \
                self.is_tensor(node.args[0]):
            self._note_sync(node, f"np.{name}()")
        # RNG consumption
        elif name in _RNG_CALLS:
            root = _root_name(func) if isinstance(func, ast.Attribute) \
                else None
            if root not in ("np", "numpy", "random", "rng"):
                self._diag(
                    "PTC002", node,
                    f"RNG consumption (`{name}`) inside the candidate "
                    f"capture region",
                    hint="a replayed segment would reuse the recorded "
                         "key stream; keep RNG ops outside the region "
                         "or accept the eager fallback (sot marks the "
                         "trace non-replayable)")
        # dynamic-shape producers
        elif name in _DYNSHAPE_CALLS:
            self._diag(
                "PTC004", node,
                f"`{name}` produces data-dependent shapes: every "
                f"distinct result shape compiles a new executable",
                hint="pad to a static bound + mask, or declare a "
                     "BucketPolicy for the consuming region")
        # in-place tensor mutators
        elif isinstance(func, ast.Attribute) and (
                name in _INPLACE_METHODS
                or (name and name.endswith("_") and len(name) > 1
                    and not name.startswith("_")
                    and self.is_tensor(func.value))):
            self._diag(
                "PTC002", node,
                f"in-place mutation `{ast.unparse(func)}()` inside the "
                f"candidate capture region",
                hint="jit/sot.py marks mutating traces non-replayable; "
                     "use the functional form or cut the region here")
        # persistent-container mutation
        elif isinstance(func, ast.Attribute) and \
                name in _CONTAINER_MUTATORS:
            recv = func.value
            persistent = _is_self_attr(recv) or (
                isinstance(recv, ast.Name)
                and recv.id in self.globals_declared)
            if persistent:
                self._diag(
                    "PTC002", node,
                    f"`{ast.unparse(recv)}.{name}()` mutates "
                    f"module/self state inside the step",
                    hint="host-state mutation is silently skipped on "
                         "replay; move it to the step boundary or "
                         "return the value")
        # host I/O
        elif isinstance(func, ast.Name) and name in ("print", "open"):
            self._diag(
                "PTC002", node,
                f"host I/O (`{name}`) inside the candidate capture "
                f"region",
                hint="I/O never replays; log outside the step or "
                     "behind a step-boundary callback")
        # device work: tensor-producing calls, plus .backward()/.step()
        # on ANY receiver — an optimizer/engine is never tainted, but
        # its step IS device work, and missing it would wrongly grade a
        # preceding host read "hoistable" (over-counting only demotes a
        # hoist to a guard, the safe direction)
        if self._call_is_tensor(node) or (
                isinstance(func, ast.Attribute)
                and name in ("backward", "step")):
            self._note_device(node)

    def visit_Subscript(self, node):
        self.generic_visit(node)
        # boolean-MASK indexing: the gather's output shape depends on
        # how many elements are true. (Integer-tensor gathers keep the
        # index's static shape and are capture-compatible — only
        # comparison-produced masks are flagged, per the zero-false-
        # positive contract.)
        if isinstance(node.ctx, ast.Load) and \
                self.is_tensor(node.value) and self._is_mask(node.slice):
            self._diag(
                "PTC004", node,
                "boolean-mask indexing: the result shape depends on "
                "runtime data",
                hint="pad to a static bound + mask, or declare a "
                     "BucketPolicy for the consuming region")

    def visit_BinOp(self, node):
        self.generic_visit(node)
        if self.is_tensor(node.left) or self.is_tensor(node.right):
            self._note_device(node)

    # one level of nested helpers is scanned as part of the region (a
    # `def loss_fn():` inside the step runs inside the step); deeper
    # nesting is out of scope — scan it as its own candidate instead
    def visit_FunctionDef(self, node):
        if self._depth == 0:
            self._depth += 1
            self.generic_visit(node)
            self._depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass

    # -- finalize --------------------------------------------------------
    def finalize(self) -> List[Diagnostic]:
        last_device = max(self.device_lines, default=0)
        for line, kind, node in self.syncs:
            if line in self.branch_lines:
                continue  # already a PTC001 at this site
            in_device_loop = any(
                lo <= line <= hi and
                any(lo <= d <= hi for d in self.device_lines)
                for lo, hi in self.loop_spans)
            tail = line >= last_device and not in_device_loop
            if tail:
                msg = (f"host read {kind} postdominates all device work "
                       f"— hoistable")
                hint = ("move the fetch after the step (or batch "
                        "fetches across steps): the step body then "
                        "captures whole")
            else:
                msg = f"host read {kind} mid-step (device work follows)"
                hint = ("a mid-step sync serializes dispatch and cuts "
                        "the capture region: make it an SOT guard, or "
                        "move the read off the step path")
            self.diags.append(Diagnostic(
                "PTC003", f"{self.relpath}:{line}", msg, hint=hint,
                data={"hoistable": tail, "kind": kind}))
        return sort_diagnostics(self.diags)


def _scan_fn_node(fn_node: ast.AST, relpath: str,
                  tensor_params: Sequence[str] = ()) -> List[Diagnostic]:
    scanner = _FnScanner(relpath, tensor_params)
    # taint to a true fixpoint first (loop-carried chains like
    # a = b; b = c; c = <tensor> need one pass per hop); each pass can
    # only add or move taint among a bounded name set, so this
    # terminates — the iteration cap is a belt for pathological
    # oscillation (taint both added and dropped around a loop)
    for _ in range(32):
        before = (frozenset(scanner.tainted), frozenset(scanner.masks))
        for stmt in fn_node.body:
            scanner.visit(stmt)
        if (frozenset(scanner.tainted),
                frozenset(scanner.masks)) == before:
            break
    scanner.collect = True
    for stmt in fn_node.body:
        scanner.visit(stmt)
    return scanner.finalize()


def scan_source(source: str, name: str = "<step>",
                tensor_params: Sequence[str] = (),
                first_line: int = 1) -> List[Diagnostic]:
    """Scan a source snippet (a module or a single def) — the seeded-
    fixture entry point for tests and ``--self-check``. When the
    snippet holds one function def, its parameters are treated as
    tensors unless ``tensor_params`` says otherwise."""
    tree = ast.parse(textwrap.dedent(source), filename=name)
    if first_line != 1:
        ast.increment_lineno(tree, first_line - 1)
    defs = [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    diags: List[Diagnostic] = []
    if len(defs) == 1 and not tensor_params:
        tensor_params = [a.arg for a in defs[0].args.args
                         if a.arg not in ("self", "cls")]
    if defs:
        for d in defs:
            diags.extend(_scan_fn_node(d, name, tensor_params))
    else:
        diags.extend(_scan_fn_node(tree, name, tensor_params))
    return sort_diagnostics(diags)


def _find_def(tree: ast.Module, qualname: str):
    """Locate a (possibly method) function def by dotted qualname."""
    parts = qualname.split(".")
    body = tree.body
    node = None
    for i, part in enumerate(parts):
        node = None
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and n.name == part:
                node = n
                break
        if node is None:
            return None
        body = getattr(node, "body", [])
    return node if isinstance(
        node, (ast.FunctionDef, ast.AsyncFunctionDef)) else None


def scan_file_function(path: str, qualname: str,
                       tensor_params: Sequence[str] = ()):
    """Scan one function of a real file. Returns ``(diags, meta)`` with
    ``meta = {"file", "function", "span"}`` (the planner's coverage
    spans)."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    tree = ast.parse(source, filename=path)
    node = _find_def(tree, qualname)
    rel = _rel(path)
    if node is None:
        raise ValueError(f"{rel}: no function {qualname!r}")
    diags = _scan_fn_node(node, rel, tensor_params)
    meta = {"file": rel, "function": qualname,
            "span": (node.lineno, getattr(node, "end_lineno",
                                          node.lineno)),
            "pragmas": _pragmas(source)}
    return diags, meta


def capture_scan(fn, tensor_params: Optional[Sequence[str]] = None):
    """Scan a live callable (plain function, bound method, SOTFunction,
    or closure). Returns ``(diags, meta)``."""
    import inspect
    target = fn
    for attr in ("_fn", "__wrapped__", "__func__"):
        inner = getattr(target, attr, None)
        if inner is not None and callable(inner):
            target = inner
    try:
        source = inspect.getsource(target)
        path = inspect.getsourcefile(target) or "<unknown>"
        first = target.__code__.co_firstlineno
    except (OSError, TypeError) as e:
        raise ValueError(
            f"capture_scan: no source for {fn!r} ({e})") from e
    tree = ast.parse(textwrap.dedent(source))
    ast.increment_lineno(tree, first - 1)
    defs = [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    if not defs:
        raise ValueError(f"capture_scan: {fn!r} is not a function def")
    node = defs[0]
    rel = _rel(path)
    if tensor_params is None:
        # default seeding: defaultless positional params are tensors (a
        # step's data args); params WITH defaults (update=True, axis=0)
        # are config knobs — seeding those would flag `if update:`
        a = node.args
        pos = list(a.posonlyargs) + list(a.args)
        n_defaults = len(a.defaults)
        seeded = pos[:len(pos) - n_defaults] if n_defaults else pos
        tensor_params = [p.arg for p in seeded
                        if p.arg not in ("self", "cls")]
    diags = _scan_fn_node(node, rel, tensor_params)
    meta = {"file": rel, "function": getattr(target, "__qualname__",
                                             node.name),
            "span": (node.lineno,
                     getattr(node, "end_lineno", node.lineno))}
    return diags, meta


def enclosing_function_scan(path: str, line: int):
    """Scan the innermost function containing ``line`` of ``path`` —
    how the planner turns a dynamic event origin into static coverage.
    Returns ``(diags, meta)`` or ``(None, None)`` when the line sits
    outside any function."""
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError):
        return None, None
    best = None
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            lo, hi = node.lineno, getattr(node, "end_lineno", node.lineno)
            if lo <= line <= hi and (
                    best is None or lo > best.lineno):
                best = node
    if best is None:
        return None, None
    rel = _rel(path)
    diags = _scan_fn_node(best, rel, ())
    meta = {"file": rel, "function": best.name,
            "span": (best.lineno, getattr(best, "end_lineno",
                                          best.lineno)),
            "pragmas": _pragmas(source)}
    return diags, meta


# ---------------------------------------------------------------------------
# the repo's own step functions (satellite gate, run in tier-1)
# ---------------------------------------------------------------------------

# (relpath from repo root, dotted qualname, tensor param names)
REPO_STEPS: List[Tuple[str, str, Tuple[str, ...]]] = [
    ("paddle_tpu_torch/hapi/model.py", "Model.train_batch",
     ("inputs", "labels")),
    ("paddle_tpu_torch/hapi/model.py", "Model.eval_batch",
     ("inputs", "labels")),
    ("paddle_tpu_torch/serving.py", "PagedLlamaDecodeEngine._decode_impl",
     ()),
    ("paddle_tpu_torch/serving.py", "PagedLlamaDecodeEngine._prefill_impl",
     ()),
    ("paddle_tpu_torch/serving.py", "PagedLlamaDecodeEngine.step", ()),
    ("paddle_tpu_torch/serving.py", "PagedLlamaDecodeEngine.decode_steps",
     ()),
    ("paddle_tpu_torch/serving.py", "PagedLlamaDecodeEngine.prefill_chunk",
     ()),
    ("paddle_tpu_torch/serving.py", "PagedLlamaDecodeEngine._propose_impl",
     ()),
    ("paddle_tpu_torch/serving.py",
     "PagedLlamaDecodeEngine._spec_verify_impl", ()),
    ("paddle_tpu_torch/serving.py", "PagedLlamaDecodeEngine.spec_step", ()),
    ("paddle_tpu_torch/jit/sot.py", "CapturedStep.prewarm", ()),
    ("paddle_tpu_torch/jit/api.py", "TrainStep.__call__", ()),
    ("paddle_tpu_torch/amp/grad_scaler.py", "GradScaler.step", ()),
]


class CaptureScanResult:
    def __init__(self):
        self.diagnostics: List[Diagnostic] = []
        self.suppressed: List[Tuple[Diagnostic, str]] = []
        self.functions: List[Dict[str, Any]] = []

    def render(self) -> str:
        lines = [f"capture scan: {len(self.functions)} step function(s), "
                 f"{len(self.diagnostics)} finding(s), "
                 f"{len(self.suppressed)} allowlisted"]
        for d in self.diagnostics:
            lines.append(d.render())
        if self.suppressed:
            lines.append("  allowlisted (rule @ location — justification):")
            for d, why in self.suppressed:
                lines.append(f"    {d.rule} @ {d.location} — {why}")
        return "\n".join(lines)


def apply_allowlist(diags: List[Diagnostic],
                    pragma_map: Optional[Dict[int, Set[str]]] = None,
                    use_allowlist: bool = True):
    """Split raw PTC findings into (kept, suppressed) via the capture
    allowlist + inline pragmas — the matching rule is literally the
    linter's (``lint.allowlist_reason``), so the two surfaces cannot
    drift."""
    from .lint import allowlist_reason
    kept: List[Diagnostic] = []
    suppressed: List[Tuple[Diagnostic, str]] = []
    entries: List[Tuple[str, str, str]] = []
    if use_allowlist:
        from .allowlist import CAPTURE_ALLOWLIST
        entries = list(CAPTURE_ALLOWLIST)
    for d in diags:
        line_s = d.location.partition(":")[2]
        line = int(line_s) if line_s.isdigit() else -1
        if use_allowlist and pragma_map and \
                d.rule in pragma_map.get(line, ()):
            suppressed.append((d, "inline pragma"))
            continue
        why = allowlist_reason(d, entries)
        if why is not None:
            suppressed.append((d, why))
        else:
            kept.append(d)
    return kept, suppressed


def scan_repo_steps(use_allowlist: bool = True) -> CaptureScanResult:
    """Run the static capture pass over the port's own step functions
    (the tier-1 gate: new unallowlisted PTC findings fail the tests,
    the test_torch_lint_clean.py pattern)."""
    result = CaptureScanResult()
    for rel, qual, params in REPO_STEPS:
        path = os.path.join(REPO_ROOT, rel)
        if not os.path.exists(path):
            continue
        diags, meta = scan_file_function(path, qual, params)
        result.functions.append(meta)
        kept, supp = apply_allowlist(diags, meta.get("pragmas"),
                                     use_allowlist)
        result.diagnostics.extend(kept)
        result.suppressed.extend(supp)
    result.diagnostics = sort_diagnostics(result.diagnostics)
    try:
        from ..observability import metrics as _om
        cd = _om.counter(
            "analysis.diagnostics_total",
            "Diagnostics emitted by the analysis plane, by rule")
        for d in result.diagnostics:
            cd.inc(rule=d.rule)
    except Exception:  # noqa: BLE001 — the scan must work standalone
        pass
    return result
