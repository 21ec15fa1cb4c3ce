"""The port's persistent artifact store against the reference's, on the CPU.

The counterpart of ``tests/test_artifact_store.py``: the two disk tiers
(optimizer output per query fingerprint; per (stage fingerprint, env
digest) the reference's AOT-exported program and the port's bucket
*structure*, since a CUDA graph cannot be serialised), their failure modes
(corruption, a mismatched compatibility header, concurrent writers,
eviction), the operator CLI, and the acceptance path: a query prepared and
served in process A is prepared again in process B with the same
``cache_dir`` and serves its previously seen buckets with **zero** new
specializations, while perturbed model weights miss every key.

Both packages run each scenario on the same tables and pipelines (trained
by the reference, carried over through its save format). Their counters
must agree — ``traces``, ``disk_hits``/``disk_misses``,
``warm_started_buckets``, ``plan_saves``, ``skipped``, ``incompatible`` —
and their scores within ``rtol=1e-5`` (a boosted ensemble sums its trees in
another order); within one package a warm run equals the cold one bitwise.
On the CPU the port's warm start marks each stored bucket resolved (it
captures nothing there), so its first call counts no trace, as the
reference's deserialized programs trace nothing.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import repro as jraven
from repro.data.datasets import make_hospital
from repro.exec.artifact_store import ArtifactStore as RefStore
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro.relational import engine as reng

import repro_torch as raven
from repro_torch.exec.artifact_store import (
    STORE_VERSION,
    ArtifactStore,
    ScalarSpec,
    TensorSpec,
    abstract_env,
    compat_header,
    env_digest,
)
from repro_torch.ml.pipeline import load_pipeline
from repro_torch.relational import engine as teng

SQL = "SELECT * FROM PREDICT(model='m', data=patients) AS p WHERE score >= :t"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = ("traces", "disk_hits", "disk_misses")
STORE_COUNTS = ("plan_hits", "plan_misses", "plan_saves", "stage_hits", "stage_misses",
                "stage_saves", "incompatible", "corrupt", "skipped", "fallbacks")


@pytest.fixture(autouse=True)
def _isolated_store():
    """Each test starts with empty plan caches and no store in either
    package, and leaks no store into later tests."""
    for eng in (reng, teng):
        eng.clear_plan_cache()
        eng.set_artifact_store(None)
    yield
    for eng in (reng, teng):
        eng.set_artifact_store(None)
        eng.clear_plan_cache()


@pytest.fixture(scope="module")
def pipes(hospital_gb, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gb") / "gb.npz")
    ref_save_pipeline(hospital_gb, path)
    return {"ref": hospital_gb, "port": load_pipeline(path), "path": path}


def _pkg(side):
    return (jraven, {}) if side == "ref" else (raven, {"device": "cpu"})


def _engine(side):
    return reng if side == "ref" else teng


def _serve_once(side, tables, pipes, cache_dir, *, sizes=(100, 200), transform="sql"):
    """connect → prepare → serve → one flushed batch per size (each its own
    bucket), on one package. Drains the store's writer before returning, so
    the disk state is deterministic. Returns (session, sorted scores)."""
    pkg, kw = _pkg(side)
    db = pkg.connect(tables, stats="auto",
                     options=pkg.ConnectOptions(cache_dir=cache_dir), **kw)
    db.register_model("m", pipes[side])
    prep = db.sql(SQL).prepare(transform=transform, params={"t": 0.5})
    prep.serve("hot")
    outs = []
    for i, n in enumerate(sizes):
        req = prep.submit(make_hospital(n, seed=40 + i).tables["patients"])
        db.flush()
        outs.append(np.sort(np.asarray(req.result["score"])))
    db.artifact_store.drain()
    return db, outs


def _fresh(side):
    eng = _engine(side)
    eng.clear_plan_cache()
    eng.set_artifact_store(None)


def _counts(db) -> dict:
    st = db.cache_stats()
    out = {k: st[k] for k in COUNTS}
    out["warm_started_buckets"] = st["server"]["warm_started_buckets"]
    out.update({k: st["artifact_store"][k] for k in STORE_COUNTS})
    return out


def _both(fn):
    """Run ``fn(side)`` for the reference, then the port; returns both."""
    return {side: fn(side) for side in ("ref", "port")}


def _assert_scores(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# store API
# ---------------------------------------------------------------------------


def test_plan_layer_roundtrip(tmp_path, hospital, pipes):
    def run(side):
        pkg, kw = _pkg(side)
        db = pkg.connect(hospital.tables, stats="auto", **kw)
        db.register_model("m", pipes[side])
        prep = db.sql(SQL).prepare(transform="sql", params={"t": 0.5})
        store = (RefStore(str(tmp_path / side)) if side == "ref"
                 else ArtifactStore(str(tmp_path / side), device="cpu"))
        assert store.save_plan("qkey", prep.plan, prep.report)
        plan, report = store.load_plan("qkey")
        assert _engine(side).plan_fingerprint(plan) == prep.fingerprint
        assert report.transforms == prep.report.transforms
        assert store.load_plan("missing") is None
        return store.stats.snapshot()

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"]["plan_hits"] == 1 and got["port"]["plan_misses"] == 1


def test_unstable_plan_content_is_skipped(tmp_path, hospital, pipes):
    """An MLtoDNN plan is never persisted: the reference's pickler refuses
    its closures, the port refuses its ``TensorOp`` program (an
    ``nn.Module`` that may hold tensors on the card)."""
    def run(side):
        pkg, kw = _pkg(side)
        db = pkg.connect(hospital.tables, stats="auto", **kw)
        db.register_model("m", pipes[side])
        prep = db.sql(SQL).prepare(transform="dnn", params={"t": 0.5})
        store = (RefStore(str(tmp_path / side)) if side == "ref"
                 else ArtifactStore(str(tmp_path / side), device="cpu"))
        assert not store.save_plan("qkey", prep.plan, prep.report)
        assert store.load_plan("qkey") is None
        return store.stats.skipped, store.stats.plan_saves

    got = _both(run)
    assert got["port"] == got["ref"] == (1, 0)


def test_env_digest_keys_structure_not_values():
    a = {"t": {"x": np.zeros(8, np.float32)}}
    b = {"t": {"x": np.ones(8, np.float32)}}
    assert env_digest(a) == env_digest(b)
    wider = {"t": {"x": np.zeros(16, np.float32)}}
    other_dtype = {"t": {"x": np.zeros(8, np.int32)}}
    renamed = {"t": {"y": np.zeros(8, np.float32)}}
    assert len({env_digest(a), env_digest(wider),
                env_digest(other_dtype), env_digest(renamed)}) == 4
    # tensors digest as the numpy arrays of their shape and dtype do, and an
    # abstract env as the concrete one it was taken from; a scalar leaf by
    # its type, never its value; a dim sort's payload cache not at all
    env = {"t": {"x": torch.zeros(8)}, "__dimsort__": {"d": {"lo": 3, "payloads": {}}}}
    assert env_digest(env) == env_digest({"t": {"x": np.zeros(8, np.float32)},
                                          "__dimsort__": {"d": {"lo": 7}}})
    abstract = abstract_env(env)
    assert abstract == {"t": {"x": TensorSpec((8,), "float32")},
                        "__dimsort__": {"d": {"lo": ScalarSpec("int")}}}
    assert env_digest(abstract) == env_digest(env)


def test_compat_header_names_the_device_and_the_kernels():
    from repro_torch.kernels import _build

    header = compat_header("cpu")
    assert header == {"store_version": STORE_VERSION, "torch_version": torch.__version__,
                      "cuda_version": torch.version.cuda, "device": "cpu",
                      "kernels": _build._digest()}


# ---------------------------------------------------------------------------
# in-process warm start (fresh compiled-plan cache, shared cache_dir)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transform", ["sql", "dnn", "none"])
def test_fresh_session_warm_starts_from_disk(tmp_path, hospital, pipes, transform):
    def run(side):
        cache = str(tmp_path / side)
        db, cold = _serve_once(side, hospital.tables, pipes, cache, transform=transform)
        cold_counts = _counts(db)
        _fresh(side)
        db, warm = _serve_once(side, hospital.tables, pipes, cache, transform=transform)
        hot = db.server.queries["hot"].compiled
        return (cold_counts, _counts(db), cold, warm, [s.disk_loads for s in hot.stages],
                hot.specializations)

    got = _both(run)
    ref, port = got["ref"], got["port"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[1]["traces"] == 0, "the warm session specialized a served bucket"
    assert port[1]["disk_hits"] > 0 and port[1]["warm_started_buckets"] >= 2
    assert port[1]["plan_hits"] == (0 if transform == "dnn" else 1)
    for c, w in zip(port[2], port[3]):
        assert np.array_equal(c, w)
    _assert_scores(port[3], ref[3])
    assert port[4] == ref[4] and any(port[4])
    # every bucket the warm session holds came off disk: none made live
    assert port[5] == ref[5] == sum(port[4])


def test_unseen_bucket_traces_live_and_persists(tmp_path, hospital, pipes):
    def run(side):
        cache = str(tmp_path / side)
        _serve_once(side, hospital.tables, pipes, cache, sizes=(100,))
        _fresh(side)
        db, _ = _serve_once(side, hospital.tables, pipes, cache, sizes=(100, 900))
        return _counts(db)

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"]["traces"] == 1 and got["port"]["stage_saves"] == 1
    assert got["port"]["disk_hits"] > 0


def test_cacheless_connect_clears_the_global_store(tmp_path, hospital):
    db = raven.connect(hospital.tables, stats=None, device="cpu",
                       options=raven.ConnectOptions(cache_dir=str(tmp_path)))
    assert teng.get_artifact_store() is db.artifact_store
    # a later cache-less session must not inherit (and write into) the
    # previous session's store
    raven.connect(hospital.tables, stats=None, device="cpu")
    assert teng.get_artifact_store() is None


def test_close_uninstalls_own_store(tmp_path, hospital):
    with raven.connect(hospital.tables, stats=None, device="cpu",
                       options=raven.ConnectOptions(cache_dir=str(tmp_path))) as db:
        assert teng.get_artifact_store() is db.artifact_store
        assert db.artifact_store.device == torch.device("cpu")
    assert teng.get_artifact_store() is None


def test_identity_hashed_stage_never_touches_the_store(tmp_path):
    """A TensorOp with a raw closure (no __fingerprint_token__) hashes by
    id(): its fingerprint is meaningless in another process, so neither
    loads nor saves may key on it."""
    store = ArtifactStore(str(tmp_path), device="cpu")
    teng.set_artifact_store(store)
    plan = teng.TensorOp(
        child=teng.Scan(table="patients", columns=["bmi"]),
        fn=lambda cols: {"double_bmi": cols["bmi"] * 2.0},
        output_names=["double_bmi"],
    )
    compiled = teng.compile_plan(plan)
    assert not compiled.graph.stages[0].content_stable
    db = {"patients": {"bmi": np.arange(8.0, dtype=np.float32)}}
    out = compiled(db, device="cpu")
    np.testing.assert_allclose(out.columns["double_bmi"].numpy(), np.arange(8.0) * 2)
    assert compiled.warm_start(store) == 0
    assert store.stats.stage_saves == 0 and store.stats.stage_misses == 0
    assert not os.listdir(os.path.join(store.root, "stages"))


def test_reregistration_does_not_fabricate_disk_hits(tmp_path, hospital, pipes):
    """Buckets specialized live (and saved) by THIS process are not counted
    as disk warm starts when the query is registered again."""
    def run(side):
        pkg, kw = _pkg(side)
        db = pkg.connect(hospital.tables, stats="auto",
                         options=pkg.ConnectOptions(cache_dir=str(tmp_path / side)), **kw)
        db.register_model("m", pipes[side])
        prep = db.sql(SQL).prepare(transform="sql", params={"t": 0.5})
        prep.serve("hot")
        prep.submit(make_hospital(100, seed=40).tables["patients"])
        db.flush()
        first = db.cache_stats()["disk_hits"]
        prep.serve("hot")  # register again under the same name
        stats = db.cache_stats()
        return first, stats["disk_hits"], stats["server"]["warm_started_buckets"]

    got = _both(run)
    assert got["port"] == got["ref"] == (0, 0, 0)


def test_a_bucket_is_digested_once_not_on_every_call(tmp_path, hospital, pipes,
                                                     monkeypatch):
    """With a store active, a stage computes the store's key (the bucket's
    structure digest) on the first call of each specialization key only;
    later calls of that key go straight to the stage. The counts stay the
    reference's over the same calls."""
    calls = []
    real = teng.env_digest

    def counting(env):
        calls.append(1)
        return real(env)

    def run(side):
        db, _ = _serve_once(side, hospital.tables, pipes, str(tmp_path / side),
                            sizes=(100, 100, 100, 900, 900))
        return db, _counts(db)

    monkeypatch.setattr(teng, "env_digest", counting)
    got = _both(run)
    assert got["port"][1] == got["ref"][1]
    stages = [s for s in got["port"][0].server.queries["hot"].compiled.graph.stages
              if s.kind == "pure" and s.content_stable]
    assert stages and len(calls) == 2 * len(stages)  # two buckets
    assert got["port"][1]["traces"] == 2 * len(stages)


# ---------------------------------------------------------------------------
# failure modes
# ---------------------------------------------------------------------------


def _entry_files(cache: str, name: str) -> list[str]:
    return [os.path.join(d, name) for d, _, files in os.walk(cache) if name in files]


def test_corrupted_stage_artifact_falls_back_live(tmp_path, hospital, pipes):
    def run(side):
        cache = str(tmp_path / side)
        _, cold = _serve_once(side, hospital.tables, pipes, cache, sizes=(100,))
        blobs = _entry_files(cache, "exported.bin" if side == "ref" else "structure.json")
        assert blobs
        for b in blobs:  # truncated + garbage: the load must fail
            with open(b, "wb") as f:
                f.write(b"\x00garbage")
        _fresh(side)
        db, warm = _serve_once(side, hospital.tables, pipes, cache, sizes=(100,))
        assert np.array_equal(cold[0], warm[0])
        return _counts(db)

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"]["traces"] >= 1 and got["port"]["corrupt"] >= 1
    # the quarantined entry was rebuilt by the live specialization
    assert got["port"]["stage_saves"] >= 1


def test_corrupted_plan_blob_falls_back_live(tmp_path, hospital, pipes):
    def run(side):
        cache = str(tmp_path / side)
        _serve_once(side, hospital.tables, pipes, cache, sizes=(100,))
        plans = _entry_files(cache, "plan.pkl")
        assert plans
        for p in plans:
            with open(p, "wb") as f:
                f.write(b"not a pickle")
        _fresh(side)
        db, _ = _serve_once(side, hospital.tables, pipes, cache, sizes=(100,))
        return _counts(db)

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"]["corrupt"] >= 1


def _rewrite_meta(cache: str, mutate) -> int:
    n = 0
    for p in _entry_files(cache, "meta.json"):
        with open(p) as f:
            meta = json.load(f)
        mutate(meta)
        with open(p, "w") as f:
            json.dump(meta, f)
        n += 1
    return n


@pytest.mark.parametrize(
    "mutate,ref_mutate",
    [
        (lambda m: m.update(store_version=STORE_VERSION + 1),
         lambda m: m.update(store_version=m["store_version"] + 1)),
        (lambda m: m.update(device="sm_80"), lambda m: m.update(backend="tpu")),
        (lambda m: m.update(torch_version="0.0.1"), lambda m: m.update(jax_version="0.0.1")),
        (lambda m: m.update(kernels="0" * 16), lambda m: m.update(backend="gpu")),
    ],
    ids=["store_version", "device", "torch_version", "kernels"],
)
def test_incompatible_artifacts_rejected(tmp_path, hospital, pipes, mutate, ref_mutate):
    """A mismatch in any field of the header is a miss, counted as
    ``incompatible`` (the reference's matching field changed alongside)."""
    def run(side):
        cache = str(tmp_path / side)
        _serve_once(side, hospital.tables, pipes, cache, sizes=(100,))
        assert _rewrite_meta(cache, ref_mutate if side == "ref" else mutate) >= 2
        _fresh(side)
        db, _ = _serve_once(side, hospital.tables, pipes, cache, sizes=(100,))
        return _counts(db)

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"]["disk_hits"] == 0 and got["port"]["traces"] >= 1
    assert got["port"]["incompatible"] >= 2


def test_concurrent_writers_do_not_clobber(tmp_path):
    """Racing saves of the same content-addressed key: atomic rename means
    one complete winner, losers discard, and the entry always loads."""
    store = ArtifactStore(str(tmp_path), device="cpu")
    env = {"t": {"x": torch.arange(32, dtype=torch.float32)}, "__row_valid__": torch.ones(32)}
    digest = env_digest(env)
    errors: list[BaseException] = []

    def writer():
        try:
            store.save_stage("stagefp", digest, env, frozenset({"__row_valid__"}))
        except BaseException as e:  # pragma: no cover - the assertion target
            errors.append(e)

    threads = [threading.Thread(target=writer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert store.stage_digests("stagefp") == [digest]
    stored = store.load_stage("stagefp", digest)
    assert stored.structure == abstract_env(env)
    assert stored.volatile == frozenset({"__row_valid__"})
    # no tmp dirs left behind
    assert not [d for d in os.listdir(store.root) if d.startswith(".art_tmp_")]


def _stores(tmp_path, side, **kw):
    root = str(tmp_path / side)
    return RefStore(root, **kw) if side == "ref" else ArtifactStore(root, device="cpu", **kw)


def _sql_prep(side, hospital, pipes):
    pkg, kw = _pkg(side)
    db = pkg.connect(hospital.tables, stats="auto", **kw)
    db.register_model("m", pipes[side])
    return db.sql(SQL).prepare(transform="sql", params={"t": 0.5})


def test_eviction_cap_bounds_the_cache_dir(tmp_path, hospital, pipes):
    def run(side):
        prep = _sql_prep(side, hospital, pipes)
        store = _stores(tmp_path, side, max_entries=3)
        for i in range(8):
            assert store.save_plan(f"q{i}", prep.plan, prep.report)
        assert len(store._entries()) <= 3
        # evicted entries miss cleanly; survivors still load
        assert store.load_plan("q0") is None
        assert store.load_plan("q7") is not None
        return store.stats.evictions

    got = _both(run)
    assert got["port"] == got["ref"] >= 5


def test_size_based_eviction_bounds_total_bytes(tmp_path, hospital, pipes):
    prep = _sql_prep("port", hospital, pipes)
    probe = ArtifactStore(str(tmp_path / "probe"), device="cpu")
    assert probe.save_plan("probe", prep.plan, prep.report)
    entry_bytes = probe.total_bytes()
    assert entry_bytes > 0
    # cap at ~3 entries' worth of bytes with a generous count cap: the size
    # bound must do the evicting
    store = ArtifactStore(str(tmp_path / "cap"), max_entries=1000,
                          max_bytes=int(entry_bytes * 3.5), device="cpu")
    for i in range(8):
        assert store.save_plan(f"q{i}", prep.plan, prep.report)
    assert store.total_bytes() <= int(entry_bytes * 3.5)
    assert store.stats.evictions >= 4
    assert store.load_plan("q7") is not None  # newest survives
    assert store.load_plan("q0") is None      # oldest evicted


def test_oversized_single_entry_is_kept_not_thrashed(tmp_path, hospital, pipes):
    prep = _sql_prep("port", hospital, pipes)
    store = ArtifactStore(str(tmp_path), max_bytes=1, device="cpu")  # all oversize
    assert store.save_plan("q0", prep.plan, prep.report)
    assert store.save_plan("q1", prep.plan, prep.report)
    # the newest entry always survives (evicting it would thrash forever)
    assert store.load_plan("q1") is not None


def test_background_writer_persists_stage_structures(tmp_path):
    store = ArtifactStore(str(tmp_path), device="cpu")
    env = {"t": {"x": torch.arange(16, dtype=torch.float32)}}
    digest = env_digest(env)
    # the async save takes the structure at once: the queue never pins a tensor
    store.save_stage_async("stagefp", digest, env)
    store.drain()
    assert store.stats.background_writes == 1
    assert store.stats.stage_saves == 1
    assert store.pending_writes() == 0
    assert store.load_stage("stagefp", digest).structure == {
        "t": {"x": TensorSpec((16,), "float32")}}
    store.drain()  # idempotent


def test_first_specialization_rides_the_writer_thread(tmp_path, hospital, pipes):
    """Serving a fresh bucket does not write to disk inline: the save lands
    via the background writer (visible after drain)."""
    def run(side):
        db, _ = _serve_once(side, hospital.tables, pipes, str(tmp_path / side), sizes=(100,))
        stats = db.cache_stats()["artifact_store"]
        assert db.artifact_store.pending_writes() == 0
        return stats["background_writes"], stats["stage_saves"]

    got = _both(run)
    assert got["port"] == got["ref"]
    assert min(got["port"]) >= 1


# ---------------------------------------------------------------------------
# the operator CLI
# ---------------------------------------------------------------------------


def _store_with_entries(root: str) -> ArtifactStore:
    store = ArtifactStore(root, device="cpu")
    for i in range(3):
        assert store.save_stage(f"fp{i:02d}" + "0" * 28, "d" * 32,
                                {"x": torch.zeros(8 + i)})
    return store


def test_store_entries_and_prune(tmp_path):
    store = _store_with_entries(str(tmp_path))
    entries = store.entries()
    assert len(entries) == 3
    assert all(e.layer == "stage" and e.compat and e.size_bytes > 0 for e in entries)
    victims = store.prune(max_age_s=0.0, dry_run=True)
    assert len(victims) == 3
    assert len(store.entries()) == 3        # dry run deleted nothing
    store.prune(max_bytes=entries[0].size_bytes)
    assert len(store.entries()) == 1        # newest survives a byte prune
    store.prune(max_age_s=0.0)
    assert store.entries() == []


def test_store_cli_inspect_and_prune(tmp_path):
    _store_with_entries(str(tmp_path))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

    def run(*a):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.exec.artifact_store",
             "--root", str(tmp_path), "--device", "cpu", *a],
            capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
        )

    out = run("inspect")
    assert out.returncode == 0, out.stderr
    assert "3 entries" in out.stdout
    assert "1 entries" in run("inspect", "--layer", "stage", "--fingerprint", "fp01").stdout
    rows = json.loads(run("inspect", "--json").stdout)
    assert {r["key"][:4] for r in rows} == {"fp00", "fp01", "fp02"}
    assert "would delete 3" in run("prune", "--max-age-s", "0", "--dry-run").stdout
    assert "deleted 3" in run("prune", "--max-age-s", "0").stdout
    assert "0 entries" in run("inspect").stdout
    assert run("prune").returncode != 0  # needs a bound


# ---------------------------------------------------------------------------
# the acceptance path: separate processes
# ---------------------------------------------------------------------------

_CHILD = """
import dataclasses, json, sys
import numpy as np
import repro_torch as raven
from repro_torch.data.datasets import make_hospital
from repro_torch.ml.pipeline import load_pipeline


def perturb_one_weight(pipe):
    # nudge one model weight: every content fingerprint downstream changes
    for n in pipe.nodes:
        for v in n.attrs.values():
            if dataclasses.is_dataclass(v):
                for f in dataclasses.fields(v):
                    arr = getattr(v, f.name)
                    if isinstance(arr, np.ndarray) and arr.dtype.kind == "f":
                        arr += 1e-3
                        return
            elif isinstance(v, np.ndarray) and v.dtype.kind == "f":
                v += 1e-3
                return
    raise RuntimeError("no float weight found to perturb")


def main():
    cache_dir, pipe_path, perturb = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
    pipe = load_pipeline(pipe_path)
    if perturb:
        perturb_one_weight(pipe)
    ds = make_hospital(512, seed=7)
    db = raven.connect(ds.tables, stats="auto", device="cpu",
                       options=raven.ConnectOptions(cache_dir=cache_dir))
    db.register_model("m", pipe)
    prep = db.sql(
        "SELECT * FROM PREDICT(model='m', data=patients) AS p "
        "WHERE score >= :t"
    ).prepare(transform="sql", params={"t": 0.5})
    prep.serve("hot")
    served = db.cache_stats()["traces"]
    sums = []
    for i, n in enumerate((100, 200)):
        req = prep.submit(make_hospital(n, seed=40 + i).tables["patients"])
        db.flush()
        sums.append(float(np.sum(req.result["score"])))
    s = db.cache_stats()
    db.close()
    print(json.dumps({
        "traces": s["traces"],
        "request_traces": s["traces"] - served,
        "disk_hits": s["disk_hits"],
        "disk_misses": s["disk_misses"],
        "warm_started_buckets": s["server"]["warm_started_buckets"],
        "plan_hits": s["artifact_store"]["plan_hits"],
        "sums": sums,
    }))


main()
"""


def _run_child(script, cache, pipe_path, perturb=False):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, script, cache, pipe_path, "1" if perturb else "0"],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cold_process_warm_start(tmp_path, pipes):
    """Process A prepares + serves; process B (fresh interpreter, same
    cache_dir) prepares again with disk hits and zero new specializations
    for the buckets A served; a perturbed model misses every key and
    specializes live. The answers are the reference's, served in this
    process on the same tables and batches."""
    script = str(tmp_path / "cold_child.py")
    with open(script, "w") as f:
        f.write(_CHILD)
    cache = str(tmp_path / "cache")

    a = _run_child(script, cache, pipes["path"])
    assert a["traces"] >= 2 and a["disk_hits"] == 0

    b = _run_child(script, cache, pipes["path"])
    assert b["disk_hits"] > 0
    assert b["plan_hits"] == 1, "process B must skip re-optimization"
    assert b["warm_started_buckets"] >= 2
    assert b["traces"] == b["request_traces"] == 0, (
        "process B specialized buckets process A stored"
    )
    assert b["sums"] == a["sums"]

    c = _run_child(script, cache, pipes["path"], perturb=True)
    assert c["disk_hits"] == 0, "changed weights must never reuse artifacts"
    assert c["traces"] >= 2, "a mismatch falls back to live specialization"

    ref_db = jraven.connect(make_hospital(512, seed=7).tables, stats="auto")
    ref_db.register_model("m", pipes["ref"])
    ref_prep = ref_db.sql(SQL).prepare(transform="sql", params={"t": 0.5}).serve("hot")
    ref_sums = []
    for i, n in enumerate((100, 200)):
        req = ref_prep.submit(make_hospital(n, seed=40 + i).tables["patients"])
        ref_db.flush()
        ref_sums.append(float(np.sum(req.result["score"])))
    np.testing.assert_allclose(b["sums"], ref_sums, rtol=1e-5)
