"""The port's MLtoDNN tensor compiler against the reference's.

``compile_pipeline_tensor(pipe).fn`` of both packages on small hospital
pipelines, with the tree strategy forced to ``"gemm"`` and to
``"traversal"``: the same weights (trained by the reference, carried over
through its save format) and the same rows give the same scores within
``atol=1e-5`` (sums over trees run in another order). On the CPU the port's
GEMM step runs the plain ``tree_gemm`` version over the program padded at
compile time (``use_kernels=None``) or the plain contraction chain
(``use_kernels=False``), and the fused featurize chain runs its plain
version.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ml as jml
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro.tensor.compile import compile_pipeline_tensor as ref_compile
from repro_torch.ml.pipeline import load_pipeline
from repro_torch.relational.table import to_device
from repro_torch.tensor.compile import TensorProgram, compile_pipeline_tensor

MODELS = {
    "gb": lambda: jml.GradientBoostingClassifier(n_estimators=10, max_depth=3),
    "rf": lambda: jml.RandomForestClassifier(n_estimators=6, max_depth=5),
    "lr": lambda: jml.LogisticRegression(alpha=0.003, n_iter=120),
}


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """name -> (reference pipeline, the port's copy of it), trained on the
    reference's hospital data."""
    from repro.data.datasets import make_hospital

    ds = make_hospital(1024, seed=1)
    out = {}
    for name, make in MODELS.items():
        ref = jml.fit_pipeline(
            ds.joined_columns(), ds.label, ds.numeric, ds.categorical,
            make(), categories=ds.categories(),
        )
        path = str(tmp_path_factory.mktemp("m") / f"{name}.npz")
        ref_save_pipeline(ref, path)
        out[name] = (ref, load_pipeline(path))
    return out


@pytest.fixture(scope="module")
def rows():
    from repro.data.datasets import make_hospital

    return make_hospital(700, seed=5).joined_columns()


def _run_both(ref_pipe, port_pipe, rows, strategy, use_kernels):
    names = ref_pipe.input_names()
    want = ref_compile(ref_pipe, strategy=strategy).fn(
        {n: jnp.asarray(rows[n]) for n in names}
    )
    comp = compile_pipeline_tensor(
        port_pipe, strategy=strategy, use_kernels=use_kernels, device="cpu"
    )
    got = comp.fn({n: to_device(rows[n], "cpu") for n in names})
    return comp, got, want


@pytest.mark.parametrize("use_kernels", [None, False])
@pytest.mark.parametrize("strategy", ["gemm", "traversal"])
@pytest.mark.parametrize("model", ["gb", "rf"])
def test_tree_pipelines_match_reference(pipelines, rows, model, strategy, use_kernels):
    ref_pipe, port_pipe = pipelines[model]
    comp, got, want = _run_both(ref_pipe, port_pipe, rows, strategy, use_kernels)
    assert set(comp.strategy.values()) == {strategy}
    assert comp.fused  # the scaler/one-hot/concat chain is one featurize step
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "cpu"
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k
        )


def test_linear_pipeline_matches_reference(pipelines, rows):
    ref_pipe, port_pipe = pipelines["lr"]
    _, got, want = _run_both(ref_pipe, port_pipe, rows, "auto", None)
    for k in want:
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k
        )


def test_program_is_a_module_with_its_constants_as_buffers(pipelines):
    """Offsets, scales, category values and the GEMM program are buffers,
    built once at compile time (the GEMM arrays already padded for the
    kernel), so ``.to(device)`` moves the whole program."""
    _, port_pipe = pipelines["gb"]
    prog = compile_pipeline_tensor(port_pipe, strategy="gemm", device="cpu").fn
    assert isinstance(prog, TensorProgram)
    bufs = dict(prog.named_buffers())
    assert bufs and all(b.device.type == "cpu" for b in bufs.values())
    trees = next(info for kind, _, info in prog.steps if kind == "trees")
    assert "traversal" not in trees  # a forced strategy keeps its form only
    A = bufs[trees["gemm"]["A"]]
    assert A.dim() == 3 and all(d % 8 == 0 for d in A.shape[1:])


def test_strategy_policy_per_device(pipelines):
    """CUDA: GEMM iff the trees have at most 128 internal nodes. CPU:
    traversal, as the reference picks off the TPU. An explicit strategy
    wins; it and the kernel knob fork the content token."""
    from repro_torch.tensor.compile import (
        GEMM_MAX_INTERNAL,
        _choose_tree_strategy,
        _max_internal,
    )

    _, port_pipe = pipelines["gb"]
    ens = next(n for n in port_pipe.nodes if n.op == "tree_ensemble").attrs["ensemble"]
    m = _max_internal(ens)
    assert m <= GEMM_MAX_INTERNAL == 128
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert _choose_tree_strategy(m, cpu) == "traversal"
    assert _choose_tree_strategy(m, cuda) == "gemm"
    assert _choose_tree_strategy(GEMM_MAX_INTERNAL, cuda) == "gemm"
    assert _choose_tree_strategy(GEMM_MAX_INTERNAL + 1, cuda) == "traversal"
    auto = compile_pipeline_tensor(port_pipe, device="cpu")
    assert set(auto.strategy.values()) == {"traversal"}
    tokens = {
        compile_pipeline_tensor(port_pipe, strategy=s, use_kernels=k,
                                device="cpu").fn.__fingerprint_token__
        for s in ("gemm", "traversal") for k in (None, False)
    }
    assert len(tokens) == 4
    again = compile_pipeline_tensor(port_pipe, strategy="gemm", device="cpu")
    assert again.fn.__fingerprint_token__ in tokens


@pytest.mark.parametrize("strategy,gemm_calls", [("auto", 0), ("gemm", 1)])
def test_auto_program_picks_its_strategy_on_each_call(
    pipelines, rows, monkeypatch, strategy, gemm_calls
):
    """An ``"auto"`` program holds both tree forms, so it stays right after
    ``.to()`` moves it: on CPU rows it runs traversal (on CUDA rows, the
    GEMM kernel). A forced strategy holds its form only and always runs it."""
    from repro_torch.kernels import ops

    _, port_pipe = pipelines["gb"]
    prog = compile_pipeline_tensor(port_pipe, strategy=strategy, device="cpu").fn
    trees = next(info for kind, _, info in prog.steps if kind == "trees")
    assert ("gemm" in trees) and (("traversal" in trees) == (strategy == "auto"))
    calls = []
    real = ops.tree_gemm_op
    monkeypatch.setattr(ops, "tree_gemm_op",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    prog({n: to_device(rows[n], "cpu") for n in port_pipe.input_names()})
    assert len(calls) == gemm_calls


@pytest.mark.parametrize("F,I,L", [(56, 32, 32), (4096, 32, 32), (59, 136, 136),
                                   (5000, 136, 136)])
def test_tree_gemm_feature_chunk_fits_every_gemm_program(F, I, L):
    """The kernel stages x and A ``feature_chunk`` features at a time, so
    every program the GEMM policy picks (up to 128 internal nodes, padded
    to 136 columns) fits one block's shared memory, however wide F is."""
    from repro_torch.kernels.tree_gemm import SMEM_LIMIT, feature_chunk, smem_bytes

    fc = feature_chunk(F, I, L)
    if smem_bytes(F, I, L) <= SMEM_LIMIT:
        assert fc == F  # x is staged once for all trees
    else:
        assert 8 <= fc < F and fc % 8 == 0
        assert smem_bytes(fc, I, L, chunked=True) <= SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        feature_chunk(F, 1024, 1024)


def test_compile_defaults_to_the_card(pipelines, monkeypatch):
    _, port_pipe = pipelines["lr"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_pipeline_tensor(port_pipe)
