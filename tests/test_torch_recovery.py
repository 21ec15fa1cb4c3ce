"""Crash-safe registry recovery and the rollback drill, the port against the
reference, on the CPU.

The counterpart of ``tests/test_recovery.py``: a session opened with
``cache_dir`` journals every registry mutation through the artifact store;
a fresh session over the same tables and cache dir calls ``db.recover()``
and gets the whole serving topology back — published versions with their
histories, live/shadow/split pointers, the rollback log, every served route
with its bucket ladder — answering previously seen shapes with no new
specialization and the same answers. A process killed with ``SIGKILL``
recovers the same way in a fresh interpreter. Rollback rides the cutover
machinery: zero dropped requests, zero new specializations. Each
in-process scenario runs on both packages; topologies, counts and a
decision tree's sums must be equal, logistic regression's within
``rtol=1e-5``. Where the reference's tests audit the registry with
``check_registry``, both packages' audits return ``[]`` here too.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import repro as jraven
from repro.analysis.registry_check import check_registry as jcheck_registry
from repro.data.datasets import make_hospital
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro.relational import engine as reng

import repro_torch as raven
from repro_torch.analysis.registry_check import check_registry
from repro_torch.errors import RecoveryError
from repro_torch.ml.pipeline import load_pipeline
from repro_torch.relational import engine as teng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SQL = "SELECT * FROM PREDICT(model='risk', data=patients) AS p"


@pytest.fixture(autouse=True)
def _isolated_store():
    for eng in (reng, teng):
        eng.clear_plan_cache()
        eng.set_artifact_store(None)
    yield
    for eng in (reng, teng):
        eng.set_artifact_store(None)
        eng.clear_plan_cache()


@pytest.fixture(scope="module")
def pipes(hospital_dt, hospital_lr, tmp_path_factory):
    out = {}
    for kind, ref_pipe in (("dt", hospital_dt), ("lr", hospital_lr)):
        path = str(tmp_path_factory.mktemp(kind) / f"{kind}.npz")
        ref_save_pipeline(ref_pipe, path)
        out[kind] = {"ref": ref_pipe, "port": load_pipeline(path), "path": path}
    return out


def _batch(n: int, seed: int) -> dict[str, np.ndarray]:
    return make_hospital(n, seed=seed).tables["patients"]


def _connect(side, tables, cache_dir=None):
    pkg = jraven if side == "ref" else raven
    kw = {} if side == "ref" else {"device": "cpu"}
    return pkg.connect(tables, stats="auto",
                       options=pkg.ConnectOptions(cache_dir=cache_dir), **kw)


def _sums(db, prep) -> list[float]:
    out = []
    for i, n in enumerate((128, 256)):
        req = prep.submit(_batch(n, seed=40 + i))
        db.flush()
        out.append(float(np.sum(req.wait(timeout=60.0)["score"])))
    return out


def _topology(db) -> dict:
    snap = db.models.snapshot()["risk"]
    return {
        "live": snap["live"],
        "shadow": snap["shadow"],
        "split": snap["split"],
        "routes": sorted(snap["routes"]),
        "versions": [(v["version"], v["state"]) for v in snap["versions"]],
        "histories": [v["history"] for v in snap["versions"]],
    }


def _both(fn):
    return {side: fn(side) for side in ("ref", "port")}


# -- in-process A/B ----------------------------------------------------------


def test_recover_restores_topology_and_results(tmp_path, hospital, pipes):
    def run(side):
        cache = str(tmp_path / side)
        db = _connect(side, hospital.tables, cache)
        db.models.publish("risk", pipes["dt"][side])
        prep = db.sql(SQL).prepare(transform="sql")
        prep.serve("q")
        sums_a = _sums(db, prep)  # v1 results, before any split
        db.models.publish("risk", pipes["lr"][side], warm="sync")
        db.models.shadow("risk", 2)
        db.models.split("risk", {2: 0.25})
        topo_a = _topology(db)
        ladder_a = db.server.route_snapshot("q")["ladder"]
        db.artifact_store.drain()
        db.close()
        (reng if side == "ref" else teng).clear_plan_cache()

        db2 = _connect(side, hospital.tables, cache)
        try:
            counts = db2.recover()
            topo_b = _topology(db2)
            assert (check_registry if side == "port" else jcheck_registry)(db2) == []
            ladder_b = db2.server.route_snapshot("q")["ladder"]
            warm = db2.cache_stats()["server"]["warm_started_buckets"]
            # route traffic deterministically back to v1 for the equality
            # leg (the shadow stays: mirrored, never returned)
            db2.models.split("risk", {})
            traces = db2.cache_stats()["traces"]
            prep2 = db2.sql(SQL).prepare(transform="sql")
            prep2.serve("q")
            sums_b = _sums(db2, prep2)
            new_traces = db2.cache_stats()["traces"] - traces
        finally:
            db2.close()
        return counts, topo_a, topo_b, ladder_a, ladder_b, sums_a, sums_b, new_traces, warm

    got = _both(run)
    counts, topo_a, topo_b, ladder_a, ladder_b, sums_a, sums_b, new, warm = got["port"]
    assert counts == {"models": 1, "versions": 2, "routes": 1, "skipped": [],
                      "recovered": True}
    assert topo_b == topo_a and ladder_b == ladder_a
    assert sums_b == sums_a
    # previously seen shapes replay warm: the ladder was restored and the
    # stage structures came off disk
    assert new == 0 and warm > 0
    ref = got["ref"]
    assert (counts, topo_a, topo_b, ladder_a, new, warm) == (
        ref[0], ref[1], ref[2], ref[3], ref[7], ref[8])
    np.testing.assert_allclose(sums_a, ref[5], rtol=1e-6)


def test_recover_error_paths(tmp_path, hospital, pipes):
    db = raven.connect(hospital.tables, stats="auto", device="cpu")
    with pytest.raises(RecoveryError, match="artifact store"):
        db.recover()
    db.close()

    db = _connect("port", hospital.tables, str(tmp_path / "c"))
    assert db.recover() == {"recovered": False}  # nothing journaled yet
    db.models.publish("risk", pipes["dt"]["port"])
    with pytest.raises(RecoveryError, match="fresh"):
        db.recover()  # refuses to clobber a non-empty registry
    db.close()


def test_journal_skips_an_unpicklable_state(tmp_path, hospital, pipes):
    """A journal write whose state does not pickle is dropped and counted;
    the registry itself keeps working."""
    db = _connect("port", hospital.tables, str(tmp_path / "c"))
    pipe = pipes["dt"]["port"].copy()
    pipe.nodes[0].attrs["unpicklable"] = lambda x: x
    db.models.publish("risk", pipe)
    stats = db.cache_stats()["artifact_store"]
    assert stats["registry_skipped"] == 1 and stats["registry_saves"] == 0
    assert db.models.resolve("risk").version == 1
    db.close()


# -- rollback drill: zero dropped, zero new specializations ------------------


def test_rollback_drill_zero_drop_zero_retrace(tmp_path, hospital, pipes):
    def run(side):
        db = _connect(side, hospital.tables, str(tmp_path / side))
        try:
            db.models.publish("risk", pipes["dt"][side])
            prep = db.sql(SQL).prepare(transform="sql")
            prep.serve("q")
            sums_v1 = _sums(db, prep)
            db.models.publish("risk", pipes["lr"][side], warm="sync")
            db.models.cutover("risk", 2)
            sums_v2 = _sums(db, prep)  # v2 serves; handles survived the swap
            recompiles = db.cache_stats()["server"]["recompiles"]
            restored = db.models.rollback("risk", reason="drill")
            sums_back = _sums(db, prep)  # v1 serves again, bitwise
            snap = db.models.snapshot()["risk"]
            assert (check_registry if side == "port" else jcheck_registry)(db) == []
            return (restored.version, restored.state, sums_v1, sums_v2, sums_back,
                    recompiles, db.cache_stats()["server"]["recompiles"],
                    snap["live"], snap["rollbacks"],
                    {v["version"]: v["events"] for v in snap["versions"]},
                    "rolled back" in prep.explain(),
                    db.cache_stats()["server"]["cutovers"])
        finally:
            db.close()

    got = _both(run)
    port, ref = got["port"], got["ref"]
    (version, state, sums_v1, sums_v2, sums_back, before, after, live, rollbacks,
     events, explained, cutovers) = port
    assert (version, state, live) == (1, "live", 1)
    assert sums_back == sums_v1
    assert after == before
    assert rollbacks == [{"model": "risk", "from": 2, "to": 1, "reason": "drill"}]
    assert any("rolled back" in e for e in events[2])
    assert any("restored live by rollback" in e for e in events[1])
    assert explained and cutovers == 2
    assert sums_v1 == ref[2]
    np.testing.assert_allclose(sums_v2, ref[3], rtol=1e-5)
    assert port[5:] == ref[5:]


# -- the acceptance path: kill -9, then recover in a fresh process -----------

_CHILD_A = """
import json, os, signal, sys
import numpy as np
import repro_torch as raven
from repro_torch.data.datasets import make_hospital
from repro_torch.ml.pipeline import load_pipeline


def main():
    cache_dir, pipe1, pipe2 = sys.argv[1], sys.argv[2], sys.argv[3]
    ds = make_hospital(512, seed=7)
    db = raven.connect(ds.tables, stats="auto", device="cpu",
                       options=raven.ConnectOptions(cache_dir=cache_dir))
    db.models.publish("risk", load_pipeline(pipe1))
    prep = db.sql(
        "SELECT * FROM PREDICT(model='risk', data=patients) AS p"
    ).prepare(transform="sql")
    prep.serve("q")
    sums = []
    for i, n in enumerate((128, 256)):
        req = prep.submit(make_hospital(n, seed=40 + i).tables["patients"])
        db.flush()
        sums.append(float(np.sum(req.wait(timeout=60.0)["score"])))
    db.models.publish("risk", load_pipeline(pipe2), warm="sync")
    db.models.shadow("risk", 2)
    snap = db.models.snapshot()["risk"]
    db.artifact_store.drain()  # the stage structures reach disk before the crash
    print(json.dumps({
        "sums": sums,
        "topology": {
            "live": snap["live"], "shadow": snap["shadow"],
            "split": snap["split"], "routes": sorted(snap["routes"]),
            "versions": [(v["version"], v["state"]) for v in snap["versions"]],
        },
    }))
    sys.stdout.flush()
    os.kill(os.getpid(), signal.SIGKILL)  # no close(), no atexit: a crash


main()
"""

_CHILD_B = """
import json, sys
import numpy as np
import repro_torch as raven
from repro_torch.analysis.registry_check import check_registry
from repro_torch.data.datasets import make_hospital


def main():
    cache_dir = sys.argv[1]
    ds = make_hospital(512, seed=7)
    db = raven.connect(ds.tables, stats="auto", device="cpu",
                       options=raven.ConnectOptions(cache_dir=cache_dir))
    counts = db.recover()
    snap = db.models.snapshot()["risk"]
    violations = [str(v) for v in check_registry(db)]
    traces0 = db.cache_stats()["traces"]
    prep = db.sql(
        "SELECT * FROM PREDICT(model='risk', data=patients) AS p"
    ).prepare(transform="sql")
    prep.serve("q")
    sums = []
    for i, n in enumerate((128, 256)):
        req = prep.submit(make_hospital(n, seed=40 + i).tables["patients"])
        db.flush()
        sums.append(float(np.sum(req.wait(timeout=60.0)["score"])))
    print(json.dumps({
        "counts": counts,
        "sums": sums,
        "violations": violations,
        "new_traces": db.cache_stats()["traces"] - traces0,
        "topology": {
            "live": snap["live"], "shadow": snap["shadow"],
            "split": snap["split"], "routes": sorted(snap["routes"]),
            "versions": [(v["version"], v["state"]) for v in snap["versions"]],
        },
    }))
    db.close()


main()
"""


def _spawn(script_path: str, *argv: str, want_signal=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, script_path, *argv],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO,
    )
    if want_signal is not None:
        assert proc.returncode == -want_signal, (proc.returncode, proc.stderr[-2000:])
    else:
        assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_sigkill_crash_recovery_across_processes(tmp_path, pipes):
    """A child journals a lifecycle and is killed with SIGKILL; a fresh
    child's ``recover()`` restores the topology and serves the same sums
    with no new specialization. The sums are the reference's, served in
    this process on the same tables and batches."""
    cache = str(tmp_path / "c")
    a_path, b_path = str(tmp_path / "child_a.py"), str(tmp_path / "child_b.py")
    with open(a_path, "w") as f:
        f.write(_CHILD_A)
    with open(b_path, "w") as f:
        f.write(_CHILD_B)

    a = _spawn(a_path, cache, pipes["dt"]["path"], pipes["lr"]["path"],
               want_signal=signal.SIGKILL)
    b = _spawn(b_path, cache)

    assert b["counts"]["recovered"]
    assert b["counts"]["routes"] == 1 and b["counts"]["skipped"] == []
    assert b["violations"] == []
    assert b["topology"] == a["topology"]
    assert b["topology"]["shadow"] == 2
    assert b["sums"] == a["sums"]
    assert b["new_traces"] == 0

    ref = jraven.connect(make_hospital(512, seed=7).tables, stats="auto")
    ref.models.publish("risk", pipes["dt"]["ref"])
    prep = ref.sql(SQL).prepare(transform="sql").serve("q")
    assert _sums(ref, prep) == a["sums"]
