"""The port's static-analysis gate against the reference's, on the CPU.

* **Lint.** The reference's lint snippets (``tests/test_analysis.py``) go
  through ``repro.analysis.concurrency.lint_source`` and the port's: the
  same rule ids at the same lines. The port's own patterns for a captured
  body (``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``torch.cuda.synchronize``, in a ``record``-ed callable or a
  ``pure_step`` closure) are ``host-in-jit`` there and nowhere else.
* **Repo clean.** ``lint_repo()`` over ``src/repro_torch`` finds nothing;
  ``CONCURRENCY_FILES`` lists exactly the port files with a class holding a
  lock field; every rule is registered once, with the reference's ids.
* **Registry audit.** One lifecycle with a fault drill (transient stage
  faults retried, publish, shadow, split, cutover, a rollback, retire) is
  driven through ``repro.connect`` and ``repro_torch.connect(device="cpu")``:
  both ``check_registry`` calls return ``[]``; then the same corruption is
  applied to both sessions, and both audits name the same rule ids.
* **Gate.** ``main(["--rules"])`` prints the reference's catalog;
  ``main(["--device", "cpu"])`` exits 0 passing the same scenarios as the
  reference's gate, and ``python -m repro_torch.analysis --device cpu``
  does so in a fresh interpreter.
"""
from __future__ import annotations

import ast
import os
import re
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

import repro as jraven
from repro.analysis import __main__ as jgate
from repro.analysis import concurrency as jlint
from repro.analysis.registry_check import check_registry as jcheck_registry
from repro.analysis.rules import rule_catalog as jrule_catalog
from repro.exec import faults as jfaults
from repro.relational import engine as reng

import repro_torch as raven
from repro_torch.analysis import __main__ as gate
from repro_torch.analysis import concurrency as lint
from repro_torch.analysis.registry_check import check_registry
from repro_torch.analysis.rules import rule_catalog
from repro_torch.exec import faults as tfaults
from repro_torch.relational import engine as teng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _found(vs) -> list[tuple[str, str]]:
    return sorted((v.rule, v.where) for v in vs)


# ---------------------------------------------------------------------------
# Lint: the reference's snippets through both lints
# ---------------------------------------------------------------------------


def _locked_class(methods: str) -> str:
    head = textwrap.dedent(
        """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition()
                self.x = 0
        """
    )
    return head + textwrap.indent(textwrap.dedent(methods), "    ")


SNIPPETS = {
    "lock-reentry": (_locked_class("""
        def f(self):
            with self._lock:
                with self._lock:
                    pass
        """), "exec/fake.py", {"lock-reentry"}),
    "condition-reentrant": (_locked_class("""
        def f(self):
            with self._cv:
                with self._cv:
                    pass
        """), "exec/fake.py", set()),
    "lock-order": (_locked_class("""
        def f(self):
            with self._lock:
                with self._cv:
                    pass

        def g(self):
            with self._cv:
                with self._lock:
                    pass
        """), "exec/fake.py", {"lock-order"}),
    "unlocked-mutation": (_locked_class("""
        def f(self):
            with self._lock:
                self.x = 1

        def g(self):
            self.x = 2
        """), "exec/fake.py", {"unlocked-mutation"}),
    "init-exempt-helper-inherits": (_locked_class("""
        def f(self):
            with self._lock:
                self.x = 1
                self._accrue()

        def _accrue(self):
            self.x += 1
        """), "exec/fake.py", set()),
    "pragma": (_locked_class("""
        def f(self):
            with self._lock:
                with self._lock:  # analysis: allow[lock-reentry]
                    pass
        """), "exec/fake.py", set()),
    "fingerprint-hygiene": (textwrap.dedent("""
        def make(fn, name):
            fn.__fingerprint_token__ = hex(id(fn))
            fn.__fingerprint_token__ = f"tok-{name}"
            return fn
        """), "tensor/fake.py", {"fingerprint-hygiene-src"}),
    "fingerprint-literal": ('def make(fn):\n    fn.__fingerprint_token__ = "v1:linear"\n',
                            "tensor/fake.py", set()),
    "host-in-jit": (textwrap.dedent("""
        import jax
        import numpy as np

        def fn(x):
            return np.sin(x)

        g = jax.jit(fn)
        """), "exec/fake.py", {"host-in-jit"}),
    "wallclock-runtime": ("import time\n\ndef f():\n    return time.time()\n",
                          "exec/fake.py", {"wallclock-timing"}),
    "wallclock-elsewhere": ("import time\n\ndef f():\n    return time.time()\n",
                            "benchmarks/fake.py", set()),
}


@pytest.mark.parametrize("case", list(SNIPPETS))
def test_lint_source_matches_the_reference(case):
    src, relpath, want = SNIPPETS[case]
    got = lint.lint_source(src, relpath)
    assert _found(got) == _found(jlint.lint_source(src, relpath))
    assert {v.rule for v in got} == want


CAPTURED = textwrap.dedent(
    """
    import time
    import numpy as np
    import torch
    from repro_torch.exec import capture

    def tick():
        n = lengths.max().item()
        host = out.cpu()
        arr = out.numpy()
        rows = out.tolist()
        torch.cuda.synchronize()
        return out

    def clean():
        return torch.argmax(out, -1)

    def pure_step(plan, inner):
        def fn(env):
            k = int(env["n"].item())
            return inner(env)
        return fn

    g = capture.record(tick, dev)
    h = capture.record(clean, dev)
    k = capture.record(lambda: out.cpu(), dev)
    """
)


def test_host_in_captured_bodies_is_flagged_where_capture_breaks():
    """The port's additions to ``host-in-jit``: each host copy or wait in a
    captured body, one violation a line; the clean body passes; the
    reference, which knows no capture, flags none of them."""
    got = _found(lint.lint_source(CAPTURED, "exec/fake.py"))
    lines = CAPTURED.splitlines()
    want = sorted(("host-in-jit", f"exec/fake.py:{i + 1}") for i, line in enumerate(lines)
                  if re.search(r"\.(item|cpu|numpy|tolist)\(\)|cuda\.synchronize", line))
    assert got == want and len(want) == 7
    assert jlint.lint_source(CAPTURED, "exec/fake.py") == []
    allowed = CAPTURED.replace("torch.cuda.synchronize()",
                               "torch.cuda.synchronize()  # analysis: allow[host-in-jit]")
    assert len(lint.lint_source(allowed, "exec/fake.py")) == 6


# ---------------------------------------------------------------------------
# The repository's own sources
# ---------------------------------------------------------------------------


def test_repo_is_lint_clean():
    result = lint.lint_repo()
    assert result.ok, result.describe()
    assert f"({len(lint.CONCURRENCY_FILES)} lock-discipline targets)" in result.passed[0]


def _files_with_class_locks(root: str) -> set[str]:
    out = set()
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    tree = ast.parse(f.read())
                if any(lint._lock_fields(n) for n in ast.walk(tree)
                       if isinstance(n, ast.ClassDef)):
                    out.add(os.path.relpath(path, root).replace(os.sep, "/"))
    return out


def test_concurrency_files_are_every_class_holding_a_lock():
    """The reference's five files, and every port file with a class that
    holds a Lock/RLock/Condition field (module-level locks stay outside the
    class-based lint, as in the reference)."""
    root = os.path.dirname(os.path.abspath(raven.__file__))
    assert set(lint.CONCURRENCY_FILES) == _files_with_class_locks(root)
    assert set(jlint.CONCURRENCY_FILES) <= set(lint.CONCURRENCY_FILES)
    assert len(set(lint.CONCURRENCY_FILES)) == len(lint.CONCURRENCY_FILES)


def test_every_rule_is_registered_once():
    ids = [r.id for r in rule_catalog()]
    assert len(ids) == len(set(ids)) and len(ids) >= 18
    assert ids == [r.id for r in jrule_catalog()]


# ---------------------------------------------------------------------------
# Registry audit: one lifecycle and fault drill on both packages
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _isolated_caches():
    for eng in (reng, teng):
        eng.clear_plan_cache()
        eng.set_artifact_store(None)
    yield
    for eng in (reng, teng):
        eng.set_artifact_store(None)
        eng.clear_plan_cache()


PACKAGES = {
    "ref": SimpleNamespace(pkg=jraven, faults=jfaults, gate=jgate,
                           check=jcheck_registry, kw={}),
    "port": SimpleNamespace(pkg=raven, faults=tfaults, gate=gate,
                            check=check_registry, kw={"device": "cpu"}),
}


def _drill(side, cache_dir: str):
    """Transient stage faults retried, then v2 published, shadowed, split,
    cut over, rolled back by a forced policy and retired. Returns the open
    session."""
    rng = np.random.default_rng(17)
    tables = {"t": {"a": rng.normal(size=64), "b": rng.normal(size=64),
                    "k": rng.integers(0, 8, size=64).astype(np.int32)}}
    batch = {"a": rng.normal(size=16), "b": rng.normal(size=16),
             "k": rng.integers(0, 8, size=16).astype(np.int32)}
    f = side.faults
    db = side.pkg.connect(tables, stats="auto", **side.kw, options=side.pkg.ConnectOptions(
        cache_dir=cache_dir, faults=f.FaultPlan({"stage": {"times": 2}}, seed=3)))
    db.models.publish("gate", side.gate._toy_pipeline())
    prep = db.sql("SELECT * FROM PREDICT(model='gate', data=t) AS p").prepare(
        transform="sql")
    prep.serve("gate_q", options=side.pkg.ServeOptions(
        retry=f.RetryPolicy(max_attempts=4, backoff_ms=0.25)))

    def traffic(n=1):
        for _ in range(n):
            req = prep.submit(batch)
            db.flush()
            req.wait(timeout=60.0)

    traffic(3)
    db.models.publish("gate", side.gate._toy_pipeline(), warm="sync")
    db.models.shadow("gate", 2)
    traffic()
    db.models.split("gate", {2: 0.25})
    traffic()
    db.models.split("gate", {})
    db.models.cutover("gate", 2)
    traffic(3)
    restored = db.models.check_rollback("gate", f.RollbackPolicy(
        max_p99_ratio=1e-9, min_requests=1))
    assert restored is not None and restored.version == 1
    db.models.retire("gate", 2)
    assert db.server.scheduler.retries >= 1
    return db


def _break_history(db):
    db.models.versions("gate")[0].history.append("published")


def _two_live(db):
    db.models.versions("gate")[1].state = "live"


def _degraded_without_fallback(db):
    db.server.queries["gate_q"].degraded = True


def _shadow_pointer(db):
    db.models._shadow["gate"] = 1


def _cold_cutover(db):
    db.server.routes["gate_q"].last_cutover_deficit = 3


def _stray_redo(db):
    sch = db.server.scheduler
    with sch._cv:
        sch._queues["gate_q"].redo.append((None, 0, 0.0))


def _stale_journal(db):
    store, key = db.artifact_store, db._journal_key()
    state = store.load_registry(key)
    state["models"]["gate"]["live"] = 2
    assert store.save_registry(key, state)


CORRUPTIONS = {
    "history": (_break_history, {"registry-state"}),
    "two-live": (_two_live, {"registry-state", "recovery-journal"}),
    "degraded-no-fallback": (_degraded_without_fallback, {"breaker-state"}),
    "shadow-pointer": (_shadow_pointer, {"registry-route", "recovery-journal"}),
    "cold-cutover": (_cold_cutover, {"registry-warm"}),
    "stray-redo": (_stray_redo, {"retry-state"}),
    "stale-journal": (_stale_journal, {"recovery-journal"}),
}


@pytest.mark.parametrize("corruption", [None, *CORRUPTIONS])
def test_check_registry_matches_the_reference(tmp_path, corruption):
    """Clean, both audits return []; after the same corruption, the same
    rule ids (the messages name the same evidence)."""
    found = {}
    for name, side in PACKAGES.items():
        db = _drill(side, str(tmp_path / name))
        try:
            assert side.check(db) == []
            if corruption is not None:
                CORRUPTIONS[corruption][0](db)
            found[name] = sorted((v.rule, v.where) for v in side.check(db))
        finally:
            with db.server.scheduler._cv:  # a stray redo must not be dispatched
                for q in db.server.scheduler._queues.values():
                    q.redo.clear()
            db.close()
    assert found["port"] == found["ref"]
    assert {r for r, _ in found["port"]} == (
        set() if corruption is None else CORRUPTIONS[corruption][1])


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def _passed(out: str) -> list[str]:
    """The gate's passed lines, less the lint's file counts and the fault
    drill's retry count (its two transient faults are retried once or
    twice, by timing, in both packages)."""
    return [re.sub(r"\d+ transient retries", "N transient retries", line)
            for line in out.splitlines()
            if line.startswith("ok: ") and "lint over" not in line]


# the two rules whose text names the port's mechanism (a torch program, a
# zero-filled run) where the reference's names its own (jnp, eval_shape)
REWORDED = {"placement-pure": ("jnp-", "torch-"),
            "schema-exec": ("(eval_shape)", "(a zero-filled run)")}


def test_rules_print_the_reference_catalog(capsys):
    """The reference's catalog line for line: ids, scopes and texts, the two
    reworded texts read back into the reference's words."""
    assert jgate.main(["--rules"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert gate.main(["--rules"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == len(rule_catalog())
    for line, ref in zip(got, want):
        rule = line.split()[0]
        if rule in REWORDED:
            new, old = REWORDED[rule][1], REWORDED[rule][0]
            assert new in line
            line = line.replace(new, old)
        assert line == ref


def test_gate_on_the_cpu_passes_the_reference_scenarios(capsys):
    assert jgate.main([]) == 0
    want = capsys.readouterr().out
    teng.clear_plan_cache()
    assert gate.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _passed(got) == _passed(want) and len(_passed(got)) == 10
    assert "lint over" in got
    assert gate.main(["--lint-only"]) == 0
    assert _passed(capsys.readouterr().out) == []


def test_gate_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "scenario 'relational-kernels'" in proc.stdout
    assert "lifecycle scenario" in proc.stdout and "faultdrill scenario" in proc.stdout


def test_gate_exits_nonzero_on_a_violation(monkeypatch, capsys):
    """A violation found by the lint fails the gate."""
    real = lint.lint_repo

    def dirty(src_root=None):
        result = real(src_root)
        result.violations.append(lint.Violation("lock-order", "seeded", "x.py:1"))
        return result

    monkeypatch.setattr(lint, "lint_repo", dirty)
    assert gate.main(["--lint-only"]) == 1
    assert "[lock-order] x.py:1" in capsys.readouterr().out
