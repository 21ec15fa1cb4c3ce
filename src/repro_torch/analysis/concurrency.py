"""Concurrency and forbidden-pattern lint over the port's runtime sources.

The serving stack (scheduler, pipeline executor, artifact store, query
server) is threaded, and its documented lock discipline lives only in
comments. This module turns that discipline into an AST pass:

  * **lock-order** — build the lock-acquisition graph from ``with
    self._lock:`` blocks (including one-level edges through ``self.method()``
    calls made while holding a lock) and reject cycles;
  * **lock-reentry** — re-acquiring a held non-reentrant ``threading.Lock``
    deadlocks; flag it statically (``RLock``/``Condition`` are reentrant);
  * **unlocked-mutation** — an instance field assigned both inside and
    outside lock blocks is a data race waiting for a scheduler. Helper
    methods whose every intra-class call site holds a lock inherit that
    lock (the ``_accrue``-style caller-holds-lock idiom); ``__init__`` is
    exempt (no concurrent access before construction completes).

Plus repo-wide forbidden patterns: non-content-addressed
``__fingerprint_token__`` assignments, host work inside captured bodies
(numpy, ``time``, ``print``, and what breaks a CUDA-graph capture the way
numpy breaks a trace: ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
``torch.cuda.synchronize``), and ``time.time()`` used for duration
measurement in runtime code.

Suppressions: a line ending in ``# analysis: allow[rule-id]`` silences that
rule on that line (used where the discipline is intentionally violated and
documented).
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.analysis import rules as R
from repro_torch.analysis.rules import AnalysisResult, Violation, violation

# lock-discipline lint targets (relative to the repro_torch package root):
# the reference's five files, plus every port file with a class that holds
# a Lock/RLock/Condition field (module-level locks are outside the
# class-based lint, as in the reference); the pattern rules below run over
# every source file
CONCURRENCY_FILES = (
    "exec/scheduler.py",
    "exec/pipeline.py",
    "exec/artifact_store.py",
    "serve/query_server.py",
    "serve/registry.py",
    "exec/capture.py",  # StageCapture: one graph's buffers, replayed by threads
    "exec/faults.py",  # FaultPlan: its firing counters
    "relational/engine.py",  # _StageRunner: a stage's keys, run by threads
)

# runtime subtrees where wall-clock timing is forbidden (perf_counter /
# monotonic only — time.time() steps under NTP and breaks durations)
RUNTIME_DIRS = ("exec", "serve", "core", "relational")

_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
_REENTRANT = {"RLock", "Condition"}  # Condition() wraps an RLock


def _allowed(lines: list[str], lineno: int, rule_id: str) -> bool:
    if not 1 <= lineno <= len(lines):
        return False
    text = lines[lineno - 1]
    return (
        f"# analysis: allow[{rule_id}]" in text
        or text.rstrip().endswith("# analysis: allow")
    )


# ---------------------------------------------------------------------------
# Lock-discipline lint
# ---------------------------------------------------------------------------


@dataclass
class _MethodInfo:
    name: str
    # (field path, held locks at mutation, lineno)
    mutations: list[tuple[str, tuple[str, ...], int]] = field(
        default_factory=list)
    # (lock field, locks already held, lineno)
    acquisitions: list[tuple[str, tuple[str, ...], int]] = field(
        default_factory=list)
    # (callee method name, locks held at call, lineno)
    calls: list[tuple[str, tuple[str, ...], int]] = field(
        default_factory=list)


def _self_attr_path(node: ast.AST) -> Optional[str]:
    """Dotted path for ``self.a.b…`` (subscripts collapse to their base)."""
    parts: list[str] = []
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Name):
            return ".".join(reversed(parts)) if node.id == "self" else None
        else:
            return None


def _lock_fields(cls: ast.ClassDef) -> dict[str, str]:
    """``self.X = threading.Lock()`` style fields -> factory name."""
    locks: dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or not isinstance(
            node.value, ast.Call
        ):
            continue
        fn = node.value.func
        name = None
        if isinstance(fn, ast.Attribute) and fn.attr in _LOCK_FACTORIES:
            name = fn.attr
        elif isinstance(fn, ast.Name) and fn.id in _LOCK_FACTORIES:
            name = fn.id
        if name is None:
            continue
        for t in node.targets:
            path = _self_attr_path(t)
            if path and "." not in path:
                locks[path] = name
    return locks


def _analyze_method(fn: ast.FunctionDef, locks: dict[str, str]) -> _MethodInfo:
    info = _MethodInfo(fn.name)

    def visit(node: ast.AST, held: tuple[str, ...]) -> None:
        if isinstance(node, ast.With):
            new_held = held
            for item in node.items:
                path = _self_attr_path(item.context_expr)
                if path in locks:
                    info.acquisitions.append((path, new_held, node.lineno))
                    new_held = new_held + (path,)
            for stmt in node.body:
                visit(stmt, new_held)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # nested closures run later, under unknown lock state: skip
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                path = _self_attr_path(t)
                if path and path not in locks:
                    info.mutations.append((path, held, node.lineno))
        if isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"
            ):
                info.calls.append((f.attr, held, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in fn.body:
        visit(stmt, ())
    return info


def _lint_class(
    cls: ast.ClassDef,
    lines: list[str],
    relpath: str,
    edges: dict[tuple[str, str], str],
) -> list[Violation]:
    locks = _lock_fields(cls)
    if not locks:
        return []
    out: list[Violation] = []
    methods = {
        n.name: _analyze_method(n, locks)
        for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }

    # reentry + direct acquisition-order edges
    for m in methods.values():
        for lock, held, lineno in m.acquisitions:
            where = f"{relpath}:{lineno}"
            if lock in held and locks[lock] not in _REENTRANT:
                if not _allowed(lines, lineno, R.LOCK_REENTRY.id):
                    out.append(violation(
                        R.LOCK_REENTRY,
                        f"{cls.name}.{m.name} re-acquires non-reentrant "
                        f"lock self.{lock} while holding it", where))
            for h in held:
                if h != lock:
                    edges.setdefault(
                        (f"{cls.name}.{h}", f"{cls.name}.{lock}"), where)

    # one-level interprocedural edges: calling a method that acquires a
    # lock while already holding one orders (held -> callee's lock)
    for m in methods.values():
        for callee, held, lineno in m.calls:
            if not held or callee not in methods:
                continue
            for lock, inner_held, _ in methods[callee].acquisitions:
                if inner_held:
                    continue  # already ordered by its own outer lock
                for h in held:
                    if h != lock:
                        edges.setdefault(
                            (f"{cls.name}.{h}", f"{cls.name}.{lock}"),
                            f"{relpath}:{lineno}")

    # caller-holds-lock promotion: a helper only ever invoked under a lock
    # inherits that lock for its (top-level) mutations
    call_sites: dict[str, list[tuple[str, ...]]] = {}
    for m in methods.values():
        if m.name == "__init__":
            continue
        for callee, held, _ in m.calls:
            if callee in methods:
                call_sites.setdefault(callee, []).append(held)
    promoted = {
        name for name, sites in call_sites.items()
        if sites and all(s for s in sites)
    }

    # unlocked-mutation: a path assigned both under a lock and outside one
    locked_paths: set[str] = set()
    unlocked: dict[str, tuple[str, int]] = {}
    for m in methods.values():
        if m.name == "__init__":
            continue
        inherits = m.name in promoted
        for path, held, lineno in m.mutations:
            if held or inherits:
                locked_paths.add(path)
            elif path not in unlocked:
                unlocked[path] = (m.name, lineno)
    for path in sorted(locked_paths & set(unlocked)):
        mname, lineno = unlocked[path]
        if _allowed(lines, lineno, R.UNLOCKED_MUTATION.id):
            continue
        out.append(violation(
            R.UNLOCKED_MUTATION,
            f"{cls.name}.{mname} mutates self.{path} outside any lock, "
            f"but it is also mutated under a lock elsewhere",
            f"{relpath}:{lineno}"))
    return out


def _check_lock_cycles(edges: dict[tuple[str, str], str]) -> list[Violation]:
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    out: list[Violation] = []
    seen_cycles: set[frozenset] = set()
    for start in graph:
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in graph.get(node, ()):
                if nxt == start:
                    cyc = frozenset(path)
                    if cyc in seen_cycles:
                        continue
                    seen_cycles.add(cyc)
                    where = edges.get((node, nxt), "")
                    out.append(violation(
                        R.LOCK_ORDER,
                        "lock-order inversion: "
                        + " -> ".join(path + [start]), where))
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))
    return out


# ---------------------------------------------------------------------------
# Forbidden-pattern lint (repo-wide)
# ---------------------------------------------------------------------------


def _token_value_violations(
    value: ast.AST, lines: list[str], relpath: str
) -> list[Violation]:
    out = []
    for node in ast.walk(value):
        bad = None
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in (
                "id", "repr", "hash", "hex", "vars"
            ):
                bad = f"{f.id}() is identity/representation-based"
            elif (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "time"
            ):
                bad = f"time.{f.attr}() makes the token time-dependent"
        elif isinstance(node, ast.JoinedStr) and any(
            isinstance(v, ast.FormattedValue) for v in node.values
        ):
            bad = (
                "interpolated f-string — object interpolation embeds "
                "reprs/addresses"
            )
        if bad is None:
            continue
        lineno = getattr(node, "lineno", value.lineno)
        if not _allowed(lines, lineno, R.FINGERPRINT_HYGIENE_SRC.id):
            out.append(violation(
                R.FINGERPRINT_HYGIENE_SRC,
                f"__fingerprint_token__ built from {bad}",
                f"{relpath}:{lineno}"))
    return out


# calls whose first argument runs captured: ``record`` (the port's CUDA-graph
# capture, exec/capture.py) and ``jit`` (the reference's, so a snippet reads
# the same through both lints)
_CAPTURE_CALLS = {"record", "jit"}


def _jitted_bodies(tree: ast.Module) -> list[ast.AST]:
    """Bodies that run captured: the callable handed to ``record``/``jit``
    (a function resolvable by name, or a lambda), plus the ``fn`` closures
    built by ``pure_step``."""
    defs: dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            defs.setdefault(node.name, node)
    bodies: list[ast.AST] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args:
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if name not in _CAPTURE_CALLS:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Lambda):
                bodies.append(arg)
            elif isinstance(arg, ast.Name) and arg.id in defs:
                bodies.append(defs[arg.id])
    pure_step = defs.get("pure_step")
    if pure_step is not None:
        bodies += [
            n for n in ast.walk(pure_step)
            if isinstance(n, ast.FunctionDef) and n.name == "fn"
        ]
    return bodies


# tensor methods that wait for the card and copy to the host: inside a
# capture they raise, as numpy does under a trace
_SYNC_METHODS = {"item", "cpu", "numpy", "tolist"}


def _dotted(node: ast.AST) -> Optional[str]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    return ".".join([node.id, *reversed(parts)])


def _host_in_jit_violations(
    tree: ast.Module, lines: list[str], relpath: str
) -> list[Violation]:
    out = []
    for fn in _jitted_bodies(tree):
        for node in ast.walk(fn):
            bad = None
            if isinstance(node, ast.Name) and node.id == "np":
                bad = "numpy (np) host computation"
            elif (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "time"
            ):
                bad = f"time.{node.attr} host callback"
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"
            ):
                bad = "print() host callback"
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _SYNC_METHODS
            ):
                bad = f".{node.func.attr}() copy to the host"
            elif (
                isinstance(node, ast.Attribute)
                and node.attr == "synchronize"
                and _dotted(node.value) == "torch.cuda"
            ):
                bad = "torch.cuda.synchronize host wait"
            if bad is None:
                continue
            lineno = getattr(node, "lineno", fn.lineno)
            name = getattr(fn, "name", "<lambda>")
            if not _allowed(lines, lineno, R.HOST_IN_JIT.id):
                out.append(violation(
                    R.HOST_IN_JIT,
                    f"{bad} inside captured body {name!r} — it would run "
                    f"once at capture or break the capture",
                    f"{relpath}:{lineno}"))
    return out


def _pattern_violations(
    tree: ast.Module, lines: list[str], relpath: str
) -> list[Violation]:
    out: list[Violation] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            if any(
                isinstance(t, ast.Attribute)
                and t.attr == "__fingerprint_token__"
                for t in node.targets
            ):
                out += _token_value_violations(node.value, lines, relpath)
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "time"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "time"
        ):
            top = relpath.replace("\\", "/").split("/")[0]
            if top in RUNTIME_DIRS and not _allowed(
                lines, node.lineno, R.WALLCLOCK_TIMING.id
            ):
                out.append(violation(
                    R.WALLCLOCK_TIMING,
                    "time.time() in runtime code — use perf_counter()/"
                    "monotonic() for durations",
                    f"{relpath}:{node.lineno}"))
    out += _host_in_jit_violations(tree, lines, relpath)
    return out


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------


def lint_source(
    source: str,
    relpath: str = "<string>",
    *,
    locks: bool = True,
    patterns: bool = True,
) -> list[Violation]:
    """Lint one source string (test/tooling entry point)."""
    tree = ast.parse(source)
    lines = source.splitlines()
    out: list[Violation] = []
    if locks:
        edges: dict[tuple[str, str], str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                out += _lint_class(node, lines, relpath, edges)
        out += _check_lock_cycles(edges)
    if patterns:
        out += _pattern_violations(tree, lines, relpath)
    return out


def lint_repo(src_root: Optional[str] = None) -> AnalysisResult:
    """Lint the repro_torch package: lock discipline on the threaded
    runtime files, forbidden patterns everywhere."""
    if src_root is None:
        import repro_torch

        src_root = os.path.dirname(os.path.abspath(repro_torch.__file__))
    result = AnalysisResult()
    edges: dict[tuple[str, str], str] = {}
    lock_targets = {os.path.join(src_root, p) for p in CONCURRENCY_FILES}
    n_files = 0
    for dirpath, _, filenames in os.walk(src_root):
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            relpath = os.path.relpath(path, src_root)
            with open(path) as f:
                source = f.read()
            try:
                tree = ast.parse(source)
            except SyntaxError as e:
                result.violations.append(Violation(
                    "lock-order", f"unparseable source: {e}", relpath))
                continue
            lines = source.splitlines()
            n_files += 1
            if path in lock_targets:
                for node in ast.walk(tree):
                    if isinstance(node, ast.ClassDef):
                        result.violations += _lint_class(
                            node, lines, relpath, edges)
            result.violations += _pattern_violations(tree, lines, relpath)
    result.violations += _check_lock_cycles(edges)
    if not result.violations:
        result.passed.append(
            f"concurrency+pattern lint over {n_files} files "
            f"({len(CONCURRENCY_FILES)} lock-discipline targets)")
    return result
