"""The port's copy of the ML substrate against the reference package's.

Training is numpy in both packages, so the port's copied trainer must give
arrays identical to the reference's on the same data and seed. Weights
trained by the reference cross over through its ``save_pipeline`` file
(read by the port's ``load_pipeline``) or as numpy arrays
(``pipeline_from_arrays``), and the port's host interpreter
(``run_pipeline``) then gives the reference's outputs exactly.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

import repro.ml as jml
import repro_torch.ml as tml
from repro.data.datasets import make_hospital as ref_make_hospital
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro_torch.data.datasets import make_credit_card, make_expedia, make_flights, make_hospital
from repro_torch.ml.pipeline import load_pipeline, pipeline_from_arrays

ESTIMATORS = {
    "dt": lambda m: m.DecisionTreeClassifier(max_depth=5),
    "gb": lambda m: m.GradientBoostingClassifier(n_estimators=6, max_depth=3),
    "rf": lambda m: m.RandomForestClassifier(n_estimators=4, max_depth=4),
    "lr": lambda m: m.LogisticRegression(alpha=0.003, n_iter=60),
}


@pytest.fixture(scope="module")
def train_ds():
    return make_hospital(512, seed=4)


def _fit(pkg, ds, kind):
    return pkg.fit_pipeline(
        ds.joined_columns(), ds.label, ds.numeric, ds.categorical,
        ESTIMATORS[kind](pkg), categories=ds.categories(),
    )


def _same_value(a, b) -> bool:
    if dataclasses.is_dataclass(a):
        return type(a).__name__ == type(b).__name__ and all(
            _same_value(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)
        )
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _assert_same_pipeline(mine, theirs) -> None:
    assert [(s.name, s.kind) for s in mine.inputs] == [
        (s.name, s.kind) for s in theirs.inputs
    ]
    assert list(mine.outputs) == list(theirs.outputs)
    assert len(mine.nodes) == len(theirs.nodes)
    for a, b in zip(mine.nodes, theirs.nodes):
        assert (a.op, list(a.inputs), list(a.outputs)) == (
            b.op, list(b.inputs), list(b.outputs)
        )
        assert sorted(a.attrs) == sorted(b.attrs)
        for k in a.attrs:
            assert _same_value(a.attrs[k], b.attrs[k]), f"{a.op}.{k} differs"


def _assert_same_outputs(mine_pipe, ref_pipe, ds) -> None:
    cols = ds.joined_columns()
    inputs = {n: cols[n] for n in ref_pipe.input_names()}
    want = jml.run_pipeline(ref_pipe, inputs)
    got = tml.run_pipeline(mine_pipe, inputs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", sorted(ESTIMATORS))
def test_copied_trainer_gives_identical_pipelines(train_ds, kind):
    mine, theirs = _fit(tml, train_ds, kind), _fit(jml, train_ds, kind)
    _assert_same_pipeline(mine, theirs)
    _assert_same_outputs(mine, theirs, train_ds)


@pytest.mark.parametrize("kind", ["gb", "lr"])
def test_reference_save_file_loads_in_the_port(train_ds, kind, tmp_path):
    theirs = _fit(jml, train_ds, kind)
    path = str(tmp_path / "m.npz")
    ref_save_pipeline(theirs, path)
    mine = load_pipeline(path)
    _assert_same_pipeline(mine, theirs)
    _assert_same_outputs(mine, theirs, train_ds)


def test_pipeline_from_arrays_takes_the_reference_parameters(train_ds, tmp_path):
    """The npz+json format's two halves, handed over in memory."""
    theirs = _fit(jml, train_ds, "rf")
    path = str(tmp_path / "m.npz")
    ref_save_pipeline(theirs, path)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    mine = pipeline_from_arrays(meta, arrays)
    _assert_same_pipeline(mine, theirs)
    _assert_same_outputs(mine, theirs, train_ds)


@pytest.mark.parametrize(
    "make", [make_hospital, make_expedia, make_flights, make_credit_card]
)
def test_copied_datasets_match_the_reference(make):
    import repro.data.datasets as jds

    mine = make(300, seed=7)
    theirs = getattr(jds, make.__name__)(300, seed=7)
    assert mine.fact == theirs.fact and mine.join_keys == theirs.join_keys
    assert sorted(mine.tables) == sorted(theirs.tables)
    for t in theirs.tables:
        assert sorted(mine.tables[t]) == sorted(theirs.tables[t])
        for c in theirs.tables[t]:
            a, b = mine.tables[t][c], theirs.tables[t][c]
            assert a.dtype == b.dtype and np.array_equal(a, b), (t, c)
    assert np.array_equal(mine.label, theirs.label)


def test_reference_dataset_trains_the_same_in_both(train_ds):
    """The port's pipelines can be trained on the reference's generator
    output too (both are numpy): same arrays either way."""
    ds = ref_make_hospital(512, seed=4)
    _assert_same_pipeline(_fit(tml, ds, "gb"), _fit(tml, train_ds, "gb"))
