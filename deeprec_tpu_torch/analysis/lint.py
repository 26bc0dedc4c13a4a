"""PyTorch-aware static lints for the deeprec_tpu_torch hot paths — the
port's copy of `deeprec_tpu/analysis/lint.py`, with the framework rules
aimed at the port's idiom:

  DRT001 retrace-hazard        torch.compile / torch.jit.script /
                               torch.jit.trace applied per call to a
                               lambda, nested closure, bound method or
                               function — a fresh wrapper per call starts
                               from an empty cache and compiles (or
                               scripts) again every time.
  DRT002 host-sync-in-hot-path .item() / .tolist() / .cpu() / .numpy() /
                               torch.cuda.synchronize / np.asarray /
                               np.array / bool() / int() / float() inside
                               functions reachable from the train-step /
                               predict roots (call-graph walk) — each waits
                               for the card next to the step.
  DRT003 row-layout            torch.zeros / empty / full / ones with a
                               literal shape in ops/ and embedding/ whose
                               trailing dim is small ([C, k], k <= 8: a row
                               of k 4-byte elements narrower than 16 bytes
                               cannot use one vector load, and rows off a
                               16-byte multiple split their loads), or a
                               non-pow2 static 1-D buffer size (off the
                               power-of-two size ladder the budgets use).
  DRT004 thread-safety         member access on @not_thread_safe objects
                               (HostKV, DiskKV, the checkpoint write half)
                               or field writes on @guarded_by objects from
                               functions launched via threading.Thread /
                               executor submit, outside a `with <lock>:`
                               block.
  DRT005 unused-import         mechanical hygiene the visitor reports
                               for free.
  DRT006 shadowed-name         parameters shadowing builtins or module
                               imports.
  DRT007 metric-label-cardinality
                               obs-plane metric constructors whose label
                               VALUE interpolates per-request data (a user
                               id, a raw key, a request payload), so the
                               series set grows without bound.

DRT004-DRT007 do not depend on the framework and read as the JAX
package's rules do.

Suppression: a trailing ``# noqa: DRT004`` (comma-list allowed) on the
flagged line, with a one-line justification after it. Pre-existing
findings live in the checked-in baseline (analysis/baseline.txt): `--check`
fails only on NEW findings — and on STALE baseline entries, so the baseline
cannot rot silently; `--fix-baseline` regenerates it in one command.

The analyzer is pure-AST: it imports neither torch nor jax and never
executes the code under analysis (the `python -m` CLI still pays the
parent package's torch import on startup).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

RULES = {
    "DRT001": "retrace-hazard: per-call torch.compile / torch.jit of a "
              "lambda/closure/bound method",
    "DRT002": "host-sync-in-hot-path: device round-trip reachable from a "
              "train/predict root",
    "DRT003": "row-layout: small trailing dim or non-pow2 static buffer in "
              "ops//embedding/",
    "DRT004": "thread-safety: unguarded access to an annotated object from "
              "thread-launched code",
    "DRT005": "unused-import",
    "DRT006": "shadowed-name: parameter shadows a builtin or module import",
    "DRT007": "metric-label-cardinality: metric label value derived from "
              "per-request data",
}

# DRT002 call-graph roots: any function/method with one of these names.
ROOT_NAMES = frozenset({
    "train_step", "train_steps", "train_step_accum", "train_steps_async",
    "predict", "predict_versioned",
})

# DRT002 sync patterns: attribute calls (no arguments) that wait for the
# card, numpy constructors of a tensor, and the scalar conversions.
_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy"})
_NP_SYNC_FNS = frozenset({"asarray", "array"})
_SCALAR_FNS = frozenset({"bool", "int", "float"})

# DRT001: the compile entry points, as dotted names under a torch alias
_COMPILE_PATHS = frozenset({("compile",), ("jit", "script"), ("jit", "trace")})

# DRT006 builtin shadow set (curated: names that are both plausible
# identifiers and load-bearing builtins).
_SHADOW_BUILTINS = frozenset({
    "id", "type", "input", "vars", "hash", "bytes", "object", "dir",
    "next", "sum", "min", "max", "map", "filter", "list", "dict", "set",
    "str", "int", "float", "bool", "len", "iter", "all", "any", "open",
    "range", "zip", "sorted", "round", "format", "compile", "eval",
})

_NOQA_RE = re.compile(r"#\s*noqa:\s*((?:DRT\d+\s*,?\s*)+)", re.IGNORECASE)


# --------------------------------------------------------------------- model


@dataclasses.dataclass
class Finding:
    rule: str
    path: str          # repo-relative
    line: int
    col: int
    scope: str         # enclosing function qualname ("<module>" otherwise)
    message: str
    snippet: str       # normalized source line (fingerprint component)

    def fingerprint(self) -> str:
        return f"{self.rule}|{self.path}|{self.scope}|{self.snippet}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.scope}] {self.message}")


@dataclasses.dataclass
class FuncInfo:
    qual: str                      # "relpath::Class.method"
    name: str                      # simple name
    cls: Optional[str]
    node: ast.AST                  # FunctionDef / AsyncFunctionDef
    module: "Module"
    thread_entry: bool = False


class Module:
    """One parsed source file plus everything the rules need from it."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.noqa: Dict[int, Set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _NOQA_RE.search(text)
            if m:
                codes = {c.strip().upper()
                         for c in m.group(1).split(",") if c.strip()}
                self.noqa[i] = codes
        # import maps
        self.imports: Dict[str, str] = {}       # local name -> module path
        self.import_nodes: List[Tuple[ast.AST, str]] = []  # (node, name)
        self.np_aliases: Set[str] = set()
        self.torch_aliases: Set[str] = set()    # names bound to torch
        self.jit_aliases: Set[str] = set()      # names bound to torch.jit
        self.compile_names: Set[str] = set()    # bare names of a compile entry
        self.partial_names: Set[str] = set()    # functools.partial aliases
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    self.imports[local] = a.name
                    self.import_nodes.append((node, local))
                    if a.name == "numpy":
                        self.np_aliases.add(local)
                    elif a.name == "torch" or (a.name.startswith("torch.")
                                               and not a.asname):
                        self.torch_aliases.add(local)
                    elif a.name == "torch.jit":
                        self.jit_aliases.add(local)
                    elif a.name == "functools":
                        self.partial_names.add(local + ".partial")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    local = a.asname or a.name
                    self.imports[local] = f"{node.module}.{a.name}" \
                        if node.module else a.name
                    self.import_nodes.append((node, local))
                    if node.module == "torch" and a.name == "compile":
                        self.compile_names.add(local)
                    if node.module == "torch" and a.name == "jit":
                        self.jit_aliases.add(local)
                    if node.module == "torch.jit" and a.name in ("script",
                                                                 "trace"):
                        self.compile_names.add(local)
                    if node.module == "functools" and a.name == "partial":
                        self.partial_names.add(local)
        # function table (methods + module functions; nested defs belong
        # to their enclosing function's body, not the table)
        self.functions: List[FuncInfo] = []
        self._collect_functions(self.tree, cls=None)

    def _collect_functions(self, node, cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{self.relpath}::" + (
                    f"{cls}.{child.name}" if cls else child.name
                )
                self.functions.append(FuncInfo(q, child.name, cls, child, self))
            elif isinstance(child, ast.ClassDef):
                self._collect_functions(child, cls=child.name)
            elif isinstance(child, (ast.If, ast.Try)):
                self._collect_functions(child, cls=cls)

    def is_suppressed(self, rule: str, line: int) -> bool:
        return rule in self.noqa.get(line, ())

    def snippet_at(self, line: int) -> str:
        text = self.lines[line - 1] if 0 < line <= len(self.lines) else ""
        text = _NOQA_RE.sub("", text)
        return re.sub(r"\s+", " ", text).strip().replace("|", "¦")[:120]


# ------------------------------------------------------------------- helpers


def _dotted(node) -> str:
    """Best-effort dotted-name text of an expression ('' if not a name)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def _is_jit_ref(node, mod: Module) -> bool:
    """Does this expression denote torch.compile, torch.jit.script or
    torch.jit.trace (or an alias)?"""
    d = _dotted(node)
    if not d:
        return False
    if d in mod.compile_names:
        return True
    parts = d.split(".")
    if parts[0] in mod.torch_aliases:
        return tuple(parts[1:]) in _COMPILE_PATHS
    if parts[0] in mod.jit_aliases:
        return tuple(parts[1:]) in (("script",), ("trace",))
    return False


def _jit_target(call: ast.Call, mod: Module):
    """For a call that compiles a callable, the wrapped callable node (None
    when the call is torch.compile(...) used with only kwargs, e.g. as a
    decorator factory)."""
    if _is_jit_ref(call.func, mod):
        return call.args[0] if call.args else None
    # partial(torch.compile, ...) / functools.partial(torch.compile, ...)
    d = _dotted(call.func)
    if d in mod.partial_names and call.args \
            and _is_jit_ref(call.args[0], mod):
        return call.args[1] if len(call.args) > 1 else None
    return None


def _enclosing_functions(tree) -> Dict[ast.AST, ast.AST]:
    """Map every node to its nearest enclosing FunctionDef (or None)."""
    out: Dict[ast.AST, ast.AST] = {}

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            out[child] = fn
            walk(child, child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ) else fn)

    walk(tree, None)
    return out


def _pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


# ----------------------------------------------------------- DRT001 retrace


def _rule_retrace(mod: Module, findings: List[Finding]) -> None:
    encl = _enclosing_functions(mod.tree)
    for fi in mod.functions:
        fn = fi.node
        if fi.name == "__init__":
            # Per-instance compile of bound methods in a constructor is the
            # idiomatic "compile once per object" pattern — callers hold
            # one instance across many calls, so there is no per-call
            # recompile. Rebuilders elsewhere must justify themselves with
            # a noqa naming the rebuild contract.
            continue
        local_defs = {
            n.name for n in ast.walk(fn)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not fn
        }
        module_fns = {f.name for f in mod.functions}
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                target = _jit_target(node, mod)
                if target is None:
                    continue
                kind = None
                if isinstance(target, ast.Lambda):
                    kind = "a lambda"
                elif isinstance(target, ast.Attribute):
                    kind = f"bound method .{target.attr}"
                elif isinstance(target, ast.Name) \
                        and target.id in local_defs:
                    kind = f"nested function {target.id}()"
                elif isinstance(target, ast.Name) and (
                    target.id in module_fns or target.id in mod.imports
                ):
                    # compiling a module-level / imported function per
                    # call is the same hazard: each call returns a NEW
                    # wrapper (torch.jit scripts or traces again), even
                    # for the identical stable callable.
                    kind = f"function {target.id}() (fresh wrapper per call)"
                if kind:
                    findings.append(Finding(
                        "DRT001", mod.relpath, node.lineno, node.col_offset,
                        fi.qual.split("::")[1],
                        f"torch.compile / torch.jit applied per-call to "
                        f"{kind}: a fresh wrapper per invocation starts "
                        "from an empty cache and compiles again every time "
                        "— hoist the wrapper to module/instance scope or "
                        "justify with a noqa",
                        mod.snippet_at(node.lineno),
                    ))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn and encl.get(node) is not None:
                for dec in node.decorator_list:
                    c = dec if isinstance(dec, ast.Call) else None
                    if _is_jit_ref(dec, mod) or (
                        c is not None and (
                            _is_jit_ref(c.func, mod)
                            or (_dotted(c.func) in mod.partial_names
                                and c.args and _is_jit_ref(c.args[0], mod))
                        )
                    ):
                        findings.append(Finding(
                            "DRT001", mod.relpath, node.lineno,
                            node.col_offset, fi.qual.split("::")[1],
                            f"@torch.compile / @torch.jit on nested "
                            f"function {node.name}() — re-decorated (and "
                            "compiled again) on every call of the "
                            "enclosing function",
                            mod.snippet_at(node.lineno),
                        ))


# ------------------------------------------------- DRT002 host-sync hot path


def _build_call_graph(mods: List[Module]):
    """(by_name, edges, alias_map): best-effort package call graph.

    Deliberately an over-approximation — attribute calls resolve to every
    package function of that name, and bare references to package
    functions count as edges (that is what makes nested step bodies and
    callbacks handed to other functions reachable). False reachability costs a baseline
    entry; a missed edge costs a silent hot-path sync, so the bias is
    chosen."""
    by_name: Dict[str, List[FuncInfo]] = {}
    by_qual: Dict[str, FuncInfo] = {}
    for m in mods:
        for fi in m.functions:
            by_name.setdefault(fi.name, []).append(fi)
            by_qual[fi.qual] = fi
    fn_names = set(by_name)
    # alias map: self.NAME = <expr referencing package function F>
    alias: Dict[str, Set[str]] = {}
    for m in mods:
        for fi in m.functions:
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        refs = {
                            n.attr for n in ast.walk(node.value)
                            if isinstance(n, ast.Attribute)
                            and n.attr in fn_names
                        } | {
                            n.id for n in ast.walk(node.value)
                            if isinstance(n, ast.Name) and n.id in fn_names
                        }
                        if refs:
                            alias.setdefault(t.attr, set()).update(refs)

    edges: Dict[str, Set[str]] = {q: set() for q in by_qual}
    for m in mods:
        for fi in m.functions:
            out = edges[fi.qual]
            for node in ast.walk(fi.node):
                names: Set[str] = set()
                if isinstance(node, ast.Call):
                    if isinstance(node.func, ast.Name):
                        n = node.func.id
                        if n in m.imports:
                            leaf = m.imports[n].rsplit(".", 1)[-1]
                            names.add(leaf)
                        names.add(n)
                    elif isinstance(node.func, ast.Attribute):
                        names.add(node.func.attr)
                elif isinstance(node, ast.Attribute):
                    names.add(node.attr)
                elif isinstance(node, ast.Name):
                    names.add(node.id)
                for n in names:
                    for target in alias.get(n, ()):
                        for t in by_name.get(target, ()):
                            out.add(t.qual)
                    for t in by_name.get(n, ()):
                        out.add(t.qual)
    return by_qual, edges


def _reachable(by_qual, edges) -> Dict[str, List[str]]:
    """qual -> chain of simple names from its root (BFS shortest)."""
    chains: Dict[str, List[str]] = {}
    dq = deque()
    for q, fi in by_qual.items():
        if fi.name in ROOT_NAMES:
            chains[q] = [fi.name]
            dq.append(q)
    while dq:
        q = dq.popleft()
        for nxt in edges.get(q, ()):
            if nxt not in chains:
                chains[nxt] = chains[q] + [by_qual[nxt].name]
                dq.append(nxt)
    return chains


def _rule_host_sync(mods: List[Module], findings: List[Finding]) -> None:
    by_qual, edges = _build_call_graph(mods)
    chains = _reachable(by_qual, edges)
    for q, chain in chains.items():
        fi = by_qual[q]
        m = fi.module
        via = " -> ".join(chain[:5]) + (" -> ..." if len(chain) > 5 else "")
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            what = None
            f = node.func
            if isinstance(f, ast.Attribute):
                if f.attr in _SYNC_ATTRS and not node.args \
                        and not node.keywords:
                    what = f".{f.attr}()"
                elif isinstance(f.value, ast.Name) \
                        and f.value.id in m.np_aliases \
                        and f.attr in _NP_SYNC_FNS:
                    what = f"np.{f.attr}()"
                elif f.attr == "synchronize" and _dotted(f.value).split(
                        ".")[0] in m.torch_aliases \
                        and _dotted(f.value).endswith("cuda"):
                    what = "torch.cuda.synchronize()"
            elif isinstance(f, ast.Name) and f.id in _SCALAR_FNS \
                    and len(node.args) == 1 \
                    and not isinstance(node.args[0], ast.Constant):
                what = f"{f.id}()"
            if what:
                findings.append(Finding(
                    "DRT002", m.relpath, node.lineno, node.col_offset,
                    q.split("::")[1],
                    f"{what} forces a host sync inside a function reachable "
                    f"from a hot-path root ({via}) — on a CUDA tensor it "
                    "waits for the card; move it off the step or justify "
                    "with a noqa",
                    m.snippet_at(node.lineno),
                ))


# ------------------------------------------------------ DRT003 row layout


def _literal_shape(node: ast.Call, attr: str):
    """The shape elements of a torch creator call, when written out: a
    tuple/list first argument, or (zeros / ones / empty) the positional
    sizes themselves."""
    if not node.args:
        return None
    first = node.args[0]
    if isinstance(first, (ast.Tuple, ast.List)):
        return first.elts or None
    if attr == "full" or isinstance(first, ast.Starred):
        return None
    return [a for a in node.args]


def _rule_layout(mod: Module, findings: List[Finding]) -> None:
    if not ("/ops/" in "/" + mod.relpath or "/embedding/" in "/" + mod.relpath):
        return
    encl = _enclosing_functions(mod.tree)

    def scope_of(node):
        fn = encl.get(node)
        while fn is not None and isinstance(fn, ast.Lambda):
            fn = encl.get(fn)
        return fn.name if fn is not None else "<module>"

    creators = {"zeros", "ones", "full", "empty"}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id in mod.torch_aliases
                and f.attr in creators):
            continue
        elts = _literal_shape(node, f.attr)
        if not elts:
            continue
        last = elts[-1]
        if len(elts) >= 2 and isinstance(last, ast.Constant) \
                and isinstance(last.value, int) and 1 <= last.value <= 8:
            lead_big = any(
                not isinstance(e, ast.Constant)
                or (isinstance(e.value, int) and e.value >= 64)
                for e in elts[:-1]
            )
            if lead_big:
                k = last.value
                findings.append(Finding(
                    "DRT003", mod.relpath, node.lineno, node.col_offset,
                    scope_of(node),
                    f"device tensor with trailing dim {k}: each row is "
                    f"{4 * k} bytes at 4-byte elements — a row narrower "
                    "than 16 bytes cannot use one vector load, and rows "
                    "off a 16-byte multiple split their loads (the [C, 3] "
                    "against [3, C] meta class) — transpose the layout or "
                    "justify with a noqa",
                    mod.snippet_at(node.lineno),
                ))
        elif len(elts) == 1 and isinstance(last, ast.Constant) \
                and isinstance(last.value, int) and last.value >= 16 \
                and not _pow2(last.value):
            findings.append(Finding(
                "DRT003", mod.relpath, node.lineno, node.col_offset,
                scope_of(node),
                f"static 1-D buffer of non-pow2 size {last.value}: off the "
                "power-of-two size ladder the budgets and row counts use, "
                "every distinct size is its own launch shape and allocator "
                "block — quantize the size or justify with a noqa",
                mod.snippet_at(node.lineno),
            ))


# ----------------------------------------------------- DRT004 thread safety


_ANNOT_DECORATORS = {"not_thread_safe", "guarded_by"}


def _annotation_registry(mods: List[Module]):
    """(classes, methods): classes maps name -> (kind, lock); methods is
    the set of simple names of @not_thread_safe functions."""
    classes: Dict[str, Tuple[str, Optional[str]]] = {}
    methods: Set[str] = set()
    for m in mods:
        for node in ast.walk(m.tree):
            if isinstance(node, ast.ClassDef):
                for dec in node.decorator_list:
                    d = dec.func if isinstance(dec, ast.Call) else dec
                    name = _dotted(d).rsplit(".", 1)[-1]
                    if name == "not_thread_safe":
                        classes[node.name] = ("nts", None)
                    elif name == "guarded_by" and isinstance(dec, ast.Call) \
                            and dec.args \
                            and isinstance(dec.args[0], ast.Constant):
                        classes[node.name] = ("guarded", dec.args[0].value)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    d = dec.func if isinstance(dec, ast.Call) else dec
                    if _dotted(d).rsplit(".", 1)[-1] == "not_thread_safe":
                        methods.add(node.name)
    return classes, methods


def _bound_attrs(mods: List[Module], classes) -> Dict[str, str]:
    """Attribute names known to hold instances of annotated classes
    (`self.host = HostKV(...)`, `self.host: Optional[HostKV]`)."""
    bound: Dict[str, str] = {}
    for m in mods:
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                cname = _dotted(node.value.func).rsplit(".", 1)[-1]
                if cname in classes:
                    for t in node.targets:
                        if isinstance(t, ast.Attribute):
                            bound[t.attr] = cname
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Attribute):
                ann = ast.dump(node.annotation)
                for cname in classes:
                    if f"'{cname}'" in ann:
                        bound[node.target.attr] = cname
    return bound


def _thread_entries(mods: List[Module]) -> Set[str]:
    """Quals of functions launched on threads/executors, closed over
    same-module bare calls and same-class self-method calls."""
    by_qual: Dict[str, FuncInfo] = {}
    for m in mods:
        for fi in m.functions:
            by_qual[fi.qual] = fi

    def resolve(m: Module, cls: Optional[str], name: str) -> List[str]:
        hits = [
            fi.qual for fi in m.functions
            if fi.name == name and (fi.cls == cls or fi.cls is None or
                                    cls is None)
        ]
        if hits:
            return hits
        # cross-module: resolve through this module's imports only
        if name in m.imports:
            leaf = m.imports[name].rsplit(".", 1)[-1]
            return [q for q, fi in by_qual.items() if fi.name == leaf]
        return []

    entries: Set[str] = set()
    for m in mods:
        for fi in m.functions:
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                target = None
                if _dotted(node.func).endswith("Thread"):
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target = kw.value
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "submit" and node.args:
                    target = node.args[0]
                if target is None:
                    continue
                if isinstance(target, ast.Attribute) and isinstance(
                        target.value, ast.Name) and target.value.id == "self":
                    entries.update(resolve(m, fi.cls, target.attr))
                elif isinstance(target, ast.Name):
                    entries.update(resolve(m, fi.cls, target.id))
    # fixpoint: propagate through self-method and same-module bare calls
    changed = True
    while changed:
        changed = False
        for q in list(entries):
            fi = by_qual.get(q)
            if fi is None:
                continue
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                tq: List[str] = []
                if isinstance(node.func, ast.Attribute) and isinstance(
                        node.func.value, ast.Name) \
                        and node.func.value.id == "self":
                    tq = [
                        g.qual for g in fi.module.functions
                        if g.name == node.func.attr and g.cls == fi.cls
                    ]
                elif isinstance(node.func, ast.Name):
                    tq = [
                        g.qual for g in fi.module.functions
                        if g.name == node.func.id and g.cls is None
                    ]
                for t in tq:
                    if t not in entries:
                        entries.add(t)
                        changed = True
    return entries


def _with_lock_lines(fn, lock_attrs: Set[str]) -> Set[int]:
    """Line numbers lexically inside a `with <...>.<lockattr>:` block."""
    lines: Set[int] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.With):
            continue
        held = any(
            _dotted(item.context_expr).rsplit(".", 1)[-1] in lock_attrs
            for item in node.items
        )
        if held:
            end = getattr(node, "end_lineno", node.lineno)
            lines.update(range(node.lineno, end + 1))
    return lines


def _rule_thread_safety(mods: List[Module], findings: List[Finding]) -> None:
    classes, nts_methods = _annotation_registry(mods)
    if not classes and not nts_methods:
        return
    bound = _bound_attrs(mods, classes)
    entries = _thread_entries(mods)
    lock_attrs = {lock for kind, lock in classes.values() if lock}
    for m in mods:
        for fi in m.functions:
            if fi.qual not in entries:
                continue
            if fi.name in nts_methods:
                continue  # the annotated function itself
            locked = _with_lock_lines(fi.node, lock_attrs)
            for node in ast.walk(fi.node):
                # call of an annotated method: self._write_plan(...)
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute) \
                        and node.func.attr in nts_methods:
                    findings.append(Finding(
                        "DRT004", m.relpath, node.lineno, node.col_offset,
                        fi.qual.split("::")[1],
                        f".{node.func.attr}() is @not_thread_safe and this "
                        "function runs on a spawned thread — serialize "
                        "externally and justify with a noqa naming the "
                        "protocol",
                        m.snippet_at(node.lineno),
                    ))
                    continue
                # member access on a bound annotated instance: *.host.put
                if isinstance(node, ast.Attribute) and isinstance(
                        node.value, ast.Attribute) \
                        and node.value.attr in bound:
                    cname = bound[node.value.attr]
                    kind, lock = classes[cname]
                    if kind == "guarded":
                        is_store = isinstance(
                            node.ctx, (ast.Store, ast.Del)
                        )
                        if not is_store or node.lineno in locked:
                            continue
                        findings.append(Finding(
                            "DRT004", m.relpath, node.lineno,
                            node.col_offset, fi.qual.split("::")[1],
                            f"field write .{node.value.attr}.{node.attr} on "
                            f"@guarded_by('{lock}') {cname} from a spawned "
                            f"thread outside `with {lock}:`",
                            m.snippet_at(node.lineno),
                        ))
                    else:
                        # No lock exemption for NTS: a `with <lock>:`
                        # block proves nothing about WHO ELSE touches the
                        # object (the lock may belong to an unrelated
                        # guarded class) — the contract is an explicit
                        # noqa naming the serialization protocol.
                        findings.append(Finding(
                            "DRT004", m.relpath, node.lineno,
                            node.col_offset, fi.qual.split("::")[1],
                            f".{node.value.attr}.{node.attr} touches "
                            f"@not_thread_safe {cname} from a spawned "
                            "thread — serialize externally and justify "
                            "with a noqa naming the protocol",
                            m.snippet_at(node.lineno),
                        ))


# -------------------------------------------- DRT007 metric label cardinality

# Metric-constructing calls whose label values the rule inspects.
_METRIC_FACTORIES = frozenset({
    "counter", "gauge", "histogram", "register_callback",
})

# Identifier shapes that smell like per-request data. Deliberately
# name-based (this is a static rule): `user_id`, `uid`, `raw_key`,
# `request`, `req`, `query`, `session_id`, `item_id`, `example` —
# underscore-delimited so `table`/`stage`/`shard` never match.
_REQ_NAME_RE = re.compile(
    r"(?:^|_)(user|uid|key|request|req|query|session|item|example|row|id)"
    r"s?(?:_|$)",
    re.IGNORECASE,
)


def _per_request_refs(expr: ast.AST) -> List[str]:
    """Names inside `expr` (including through f-strings, str() calls,
    attributes, subscripts) that match the per-request pattern."""
    hits = []
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and _REQ_NAME_RE.search(node.id):
            hits.append(node.id)
        elif isinstance(node, ast.Attribute) and \
                _REQ_NAME_RE.search(node.attr):
            hits.append(node.attr)
    return hits


def _label_dict_of(call: ast.Call) -> Optional[ast.Dict]:
    """The labels dict literal of a metric-factory call, if visible:
    `labels={...}` kwarg, or ANY positional dict literal — the factories
    take labels at different positions (counter/gauge/histogram: (name,
    help, labels); register_callback: (name, fn, help, labels)), and a
    dict literal in a metric-factory call is a labels dict in every
    idiom this rule covers."""
    for kw in call.keywords:
        if kw.arg == "labels" and isinstance(kw.value, ast.Dict):
            return kw.value
    for a in call.args:
        if isinstance(a, ast.Dict):
            return a
    return None


def _rule_label_cardinality(mod: Module, findings: List[Finding]) -> None:
    encl = _enclosing_functions(mod.tree)

    def scope_of(node):
        fn = encl.get(node)
        while fn is not None and isinstance(fn, ast.Lambda):
            fn = encl.get(fn)
        return fn.name if fn is not None else "<module>"

    def flag(node, label, refs):
        findings.append(Finding(
            "DRT007", mod.relpath, node.lineno, node.col_offset,
            scope_of(node),
            f"metric label {label} takes a value derived from per-request "
            f"data ({', '.join(sorted(set(refs)))}): unbounded series "
            "cardinality — label from a bounded set instead, or justify "
            "with a noqa",
            mod.snippet_at(node.lineno),
        ))

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute):
            continue
        attr = node.func.attr
        if attr in _METRIC_FACTORIES:
            d = _label_dict_of(node)
            if d is None:
                continue
            for k, v in zip(d.keys, d.values):
                refs = _per_request_refs(v)
                if refs:
                    key = (repr(k.value) if isinstance(k, ast.Constant)
                           else "<dynamic>")
                    flag(node, key, refs)
        elif attr == "labels":
            # prometheus-client idiom: metric.labels(user=uid, ...)
            for kw in node.keywords:
                if kw.arg is None:
                    continue
                refs = _per_request_refs(kw.value)
                if refs:
                    flag(node, repr(kw.arg), refs)
            for a in node.args:
                refs = _per_request_refs(a)
                if refs:
                    flag(node, "<positional>", refs)


# --------------------------------------------------- DRT005 / DRT006 hygiene


def _rule_unused_imports(mod: Module, findings: List[Finding]) -> None:
    if os.path.basename(mod.relpath) == "__init__.py":
        return  # re-export surface
    used: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            d = _dotted(node)
            if d:
                used.add(d.split(".")[0])
    # string-typed annotations / __all__ entries
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.isidentifier():
            used.add(node.value)
    for node, local in mod.import_nodes:
        if local not in used:
            findings.append(Finding(
                "DRT005", mod.relpath, node.lineno, node.col_offset,
                "<module>",
                f"import {local!r} is unused",
                mod.snippet_at(node.lineno),
            ))


def _rule_shadowed_names(mod: Module, findings: List[Finding]) -> None:
    module_imports = set(mod.imports)
    for fi in mod.functions:
        args = fi.node.args
        params = (
            list(args.posonlyargs) + list(args.args)
            + list(args.kwonlyargs)
            + ([args.vararg] if args.vararg else [])
            + ([args.kwarg] if args.kwarg else [])
        )
        for a in params:
            shadowed = None
            if a.arg in _SHADOW_BUILTINS:
                shadowed = "builtin"
            elif a.arg in module_imports:
                shadowed = "module import"
            if shadowed:
                findings.append(Finding(
                    "DRT006", mod.relpath, a.lineno, a.col_offset,
                    fi.qual.split("::")[1],
                    f"parameter {a.arg!r} shadows a {shadowed}",
                    mod.snippet_at(a.lineno),
                ))


# --------------------------------------------------------------- the engine


DEFAULT_TARGETS = ("deeprec_tpu_torch",)


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_baseline_path() -> str:
    return os.path.join(repo_root(), "deeprec_tpu_torch", "analysis",
                        "baseline.txt")


def collect_modules(root: str, targets: Sequence[str] = DEFAULT_TARGETS,
                    source_overrides: Optional[Dict[str, str]] = None
                    ) -> List[Module]:
    overrides = {
        os.path.abspath(k): v for k, v in (source_overrides or {}).items()
    }
    paths: List[str] = []
    for t in targets:
        p = os.path.join(root, t)
        if os.path.isfile(p) and p.endswith(".py"):
            paths.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [
                    d for d in dirnames
                    if d != "__pycache__" and not d.startswith(".")
                ]
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        paths.append(os.path.join(dirpath, f))
    mods = []
    for p in sorted(set(paths)):
        ap = os.path.abspath(p)
        if ap in overrides:
            src = overrides[ap]
        else:
            with open(p, encoding="utf-8") as f:
                src = f.read()
        rel = os.path.relpath(p, root)
        try:
            mods.append(Module(p, rel, src))
        except SyntaxError as e:
            raise SyntaxError(f"{rel}: {e}") from e
    return mods


def run_rules(mods: List[Module],
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    want = set(rules or RULES)
    findings: List[Finding] = []
    for m in mods:
        if "DRT001" in want:
            _rule_retrace(m, findings)
        if "DRT003" in want:
            _rule_layout(m, findings)
        if "DRT005" in want:
            _rule_unused_imports(m, findings)
        if "DRT006" in want:
            _rule_shadowed_names(m, findings)
        if "DRT007" in want:
            _rule_label_cardinality(m, findings)
    if "DRT002" in want:
        _rule_host_sync(mods, findings)
    if "DRT004" in want:
        _rule_thread_safety(mods, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def split_suppressed(mods: List[Module], findings: List[Finding]):
    by_rel = {m.relpath: m for m in mods}
    active, suppressed = [], []
    for f in findings:
        m = by_rel.get(f.path)
        if m is not None and m.is_suppressed(f.rule, f.line):
            suppressed.append(f)
        else:
            active.append(f)
    return active, suppressed


def fingerprints(findings: List[Finding]) -> List[str]:
    """Stable, line-number-free identities; duplicates within the same
    (rule, file, scope, snippet) get an ordinal suffix."""
    seen: Dict[str, int] = {}
    out = []
    for f in findings:
        base = f.fingerprint()
        n = seen.get(base, 0) + 1
        seen[base] = n
        out.append(base if n == 1 else f"{base}|#{n}")
    return out


BASELINE_HEADER = """\
# deeprec_tpu_torch.analysis baseline — pre-existing findings `--check` ignores.
# One line per accepted finding: RULE|path|scope|normalized-snippet[|#n].
# Entries are line-number-free so ordinary edits don't churn them; an
# entry whose finding no longer exists is STALE and fails the check.
# Regenerate intentionally with: python -m deeprec_tpu_torch.analysis --fix-baseline
"""


def load_baseline(path: str) -> List[str]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        return [
            ln.rstrip("\n") for ln in f
            if ln.strip() and not ln.startswith("#")
        ]


def write_baseline(path: str, findings: List[Finding]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(BASELINE_HEADER)
        for fp in sorted(fingerprints(findings)):
            f.write(fp + "\n")


def check(root: Optional[str] = None,
          targets: Sequence[str] = DEFAULT_TARGETS,
          baseline_path: Optional[str] = None,
          rules: Optional[Sequence[str]] = None,
          fix_baseline: bool = False,
          source_overrides: Optional[Dict[str, str]] = None,
          out=None) -> int:
    """The CLI core. Returns the process exit code."""
    import sys

    out = out or sys.stdout
    root = root or repo_root()
    baseline_path = baseline_path or default_baseline_path()
    mods = collect_modules(root, targets, source_overrides)
    findings = run_rules(mods, rules)
    active, suppressed = split_suppressed(mods, findings)
    if fix_baseline:
        write_baseline(baseline_path, active)
        print(
            f"analysis: baseline rewritten with {len(active)} finding(s) "
            f"({len(suppressed)} noqa-suppressed) -> {baseline_path}",
            file=out,
        )
        return 0
    base = load_baseline(baseline_path)
    fps = fingerprints(active)
    by_fp = dict(zip(fps, active))
    base_set = set(base)
    new = [fp for fp in fps if fp not in base_set]
    # Staleness only against entries this run COULD have produced: a
    # --rules invocation must not report other rules' entries as fixed,
    # and a path-restricted scan skips staleness entirely — DRT002
    # reachability depends on the whole package, so a partial scan
    # produces a subset of findings for reasons that are not fixes.
    # (New-finding detection above still works for focused runs.)
    if tuple(targets) == tuple(DEFAULT_TARGETS):
        want_rules = set(rules or RULES)
        relevant = {
            e for e in base_set if e.split("|", 2)[0] in want_rules
        }
        stale = sorted(relevant - set(fps))
    else:
        stale = []
    rc = 0
    if new:
        rc = 1
        print(f"analysis: {len(new)} NEW finding(s):", file=out)
        for fp in new:
            print("  " + by_fp[fp].render(), file=out)
    if stale:
        rc = 1
        print(
            f"analysis: {len(stale)} STALE baseline entr(y/ies) — the "
            "finding was fixed (good!) but the baseline still lists it; "
            "run --fix-baseline:", file=out,
        )
        for fp in stale:
            print("  " + fp, file=out)
    if rc == 0:
        counts: Dict[str, int] = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        summary = ", ".join(f"{r}:{n}" for r, n in sorted(counts.items()))
        print(
            f"analysis: ok — {len(findings)} finding(s) all accounted for "
            f"({len(suppressed)} noqa, {len(base)} baselined; {summary})",
            file=out,
        )
    return rc
