"""Pipeline statistics for the data-driven strategies (paper §5.2).

The paper gathers 22 statistics per trained pipeline; we compute the same
families: input/feature counts, featurizer-op counts and OHE output sizes,
tree counts/depths, plus structural sizes that directly predict each
transformation's cost (SQL expression size, GEMM padded dims).
"""
from __future__ import annotations

import numpy as np

from repro_torch.ml.pipeline import TrainedPipeline
from repro_torch.ml.trees import LEAF

STAT_NAMES = [
    "n_inputs",            # 1  inputs to the pipeline
    "n_features",          # 2  inputs to the model (after featurization)
    "n_ops",               # 3  operators in the pipeline
    "n_featurizers",       # 4
    "n_one_hot",           # 5
    "mean_ohe_outputs",    # 6
    "max_ohe_outputs",     # 7
    "n_scalers",           # 8
    "n_models",            # 9
    "is_tree_model",       # 10
    "is_linear_model",     # 11
    "n_trees",             # 12
    "mean_tree_depth",     # 13
    "max_tree_depth",      # 14
    "std_tree_depth",      # 15
    "n_tree_nodes",        # 16
    "n_leaves",            # 17
    "max_internal_per_tree",  # 18
    "n_nonzero_weights",   # 19
    "used_feature_frac",   # 20
    "sql_expr_size_est",   # 21
    "gemm_padded_cost",    # 22
]


def pipeline_stats(pipe: TrainedPipeline) -> np.ndarray:
    n_inputs = len(pipe.inputs)
    ohe_sizes = []
    n_scalers = 0
    n_featurizers = 0
    for n in pipe.nodes:
        if n.op in ("scaler", "normalizer", "label_encode", "one_hot", "concat",
                    "feature_extractor"):
            n_featurizers += 1
        if n.op == "one_hot":
            ohe_sizes.append(len(n.attrs["categories"]))
        if n.op == "scaler":
            n_scalers += 1

    models = pipe.model_nodes()
    is_tree = any(m.op == "tree_ensemble" for m in models)
    is_linear = any(m.op == "linear" for m in models)
    n_features = 0
    n_trees = depths_mean = depths_max = depths_std = 0.0
    n_nodes = n_leaves = max_internal = 0
    nnz = 0
    used_frac = 1.0
    sql_size = 0.0
    gemm_cost = 0.0
    for m in models:
        if m.op == "tree_ensemble":
            ens = m.attrs["ensemble"]
            n_features = max(n_features, ens.n_features)
            n_trees += ens.n_trees
            d = ens.depths().astype(np.float64)
            depths_mean = float(d.mean())
            depths_max = float(d.max())
            depths_std = float(d.std())
            n_nodes += ens.n_nodes
            n_leaves += int((ens.feature == LEAF).sum())
            per_tree = [sl.stop - sl.start for sl in ens.tree_slices()]
            max_internal = max(max_internal, max((n + 1) // 2 for n in per_tree))
            used_frac = len(ens.used_features()) / max(ens.n_features, 1)
            sql_size += 4.0 * ens.n_nodes
            I = L = max(max_internal, 1)
            gemm_cost += ens.n_trees * (ens.n_features * I + I * L)
        else:
            w = np.asarray(m.attrs["weights"])
            n_features = max(n_features, len(w))
            nnz += int(np.sum(w != 0.0))
            used_frac = nnz / max(len(w), 1)
            sql_size += 3.0 * nnz
            # mean tree depth for linear models is 0 (paper footnote 6)

    return np.asarray(
        [
            n_inputs,
            n_features,
            pipe.n_ops(),
            n_featurizers,
            len(ohe_sizes),
            float(np.mean(ohe_sizes)) if ohe_sizes else 0.0,
            float(np.max(ohe_sizes)) if ohe_sizes else 0.0,
            n_scalers,
            len(models),
            float(is_tree),
            float(is_linear),
            n_trees,
            depths_mean,
            depths_max,
            depths_std,
            n_nodes,
            n_leaves,
            max_internal,
            nnz,
            used_frac,
            sql_size,
            gemm_cost,
        ],
        dtype=np.float64,
    )
