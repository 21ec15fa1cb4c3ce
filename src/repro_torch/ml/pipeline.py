"""Trained-pipeline graphs: the ONNX-analog model format.

A :class:`TrainedPipeline` is a topologically sorted DAG of
:class:`PipelineNode` ops over named values, mirroring how ONNX-ML encodes
scikit-learn pipelines (featurizers + a model op).  Supported ops:

  scaler            y = (x - offset) * scale                (N,k) -> (N,k)
  normalizer        row-wise l1/l2/max                      (N,k) -> (N,k)
  label_encode      value -> dense code                     (N,)  -> (N,)
  one_hot           single column -> indicator matrix       (N,)  -> (N,V)
  concat            horizontal concat                       ...   -> (N,F)
  feature_extractor column subset (attrs['indices'])        (N,F) -> (N,k)
  constant          broadcast constant columns              ()    -> (N,k)
  tree_ensemble     TreeEnsemble inference -> score, label
  linear            w·x + b (+ logistic)    -> score, label

The same graph is (a) executed op-at-a-time by :func:`run_pipeline` (the
"ML runtime"), (b) rewritten by the optimizer rules in ``repro_torch.core.rules``,
(c) compiled by MLtoSQL / MLtoDNN.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from repro_torch.ml.featurizers import Normalizer
from repro_torch.ml.trees import TreeEnsemble

MODEL_OPS = ("tree_ensemble", "linear")
FEATURIZER_OPS = (
    "scaler",
    "normalizer",
    "label_encode",
    "one_hot",
    "concat",
    "feature_extractor",
    "constant",
)
# ops only the interpreted host runtime can execute: an opaque python
# callable over the feature block (sklearn FunctionTransformer / ONNX custom
# op analog). attrs: {"fn": callable}. The callable may carry
# ``__fingerprint_token__`` to make pipelines embedding it content-stable.
HOST_ONLY_OPS = ("python_udf",)


@dataclass
class PipelineNode:
    op: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Any] = field(default_factory=dict)

    def copy(self) -> "PipelineNode":
        return PipelineNode(
            op=self.op,
            inputs=list(self.inputs),
            outputs=list(self.outputs),
            attrs=dict(self.attrs),
        )


@dataclass
class InputSpec:
    name: str
    kind: str  # "numeric" | "categorical"


@dataclass
class TrainedPipeline:
    """Topo-sorted op DAG with named graph inputs/outputs."""

    inputs: list[InputSpec]
    outputs: list[str]
    nodes: list[PipelineNode]

    # ---- structure helpers -------------------------------------------------

    def input_names(self) -> list[str]:
        return [s.name for s in self.inputs]

    def producer_of(self, value: str) -> Optional[PipelineNode]:
        for n in self.nodes:
            if value in n.outputs:
                return n
        return None

    def consumers_of(self, value: str) -> list[PipelineNode]:
        return [n for n in self.nodes if value in n.inputs]

    def model_nodes(self) -> list[PipelineNode]:
        return [n for n in self.nodes if n.op in MODEL_OPS]

    def toposort(self) -> None:
        """Re-establish topological order after rewrites."""
        produced = {s.name for s in self.inputs}
        remaining = list(self.nodes)
        order: list[PipelineNode] = []
        while remaining:
            progressed = False
            for n in list(remaining):
                if all(i in produced for i in n.inputs):
                    order.append(n)
                    produced.update(n.outputs)
                    remaining.remove(n)
                    progressed = True
            if not progressed:
                raise ValueError("cycle or missing producer in pipeline graph")
        self.nodes = order

    def prune_dead(self) -> None:
        """Drop nodes whose outputs reach no graph output (after rewrites)."""
        live: set[str] = set(self.outputs)
        changed = True
        while changed:
            changed = False
            for n in self.nodes:
                if any(o in live for o in n.outputs):
                    for i in n.inputs:
                        if i not in live:
                            live.add(i)
                            changed = True
        self.nodes = [n for n in self.nodes if any(o in live for o in n.outputs)]
        self.inputs = [s for s in self.inputs if s.name in live]

    def copy(self) -> "TrainedPipeline":
        return TrainedPipeline(
            inputs=[dataclasses.replace(s) for s in self.inputs],
            outputs=list(self.outputs),
            nodes=[n.copy() for n in self.nodes],
        )

    def n_ops(self) -> int:
        return len(self.nodes)


# ---------------------------------------------------------------------------
# Interpreted execution — the "ML runtime"
# ---------------------------------------------------------------------------


def _as_2d(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    # a 1-D value is one column; reshape(n, 1) (not -1) stays valid at n == 0
    return x.reshape(x.shape[0], 1) if x.ndim == 1 else x


def _eval_node(node: PipelineNode, vals: dict[str, np.ndarray], n_rows: int):
    # Featurization runs in float32 — exactly like the real ML runtime this
    # models (ONNX Runtime tensors are f32) and like the compiled MLtoSQL /
    # MLtoDNN paths, so threshold comparisons agree bit-for-bit across all
    # three execution paths.
    a = node.attrs
    if node.op == "scaler":
        x = _as_2d(vals[node.inputs[0]]).astype(np.float32)
        vals[node.outputs[0]] = (
            x - a["offset"].astype(np.float32)
        ) * a["scale"].astype(np.float32)
    elif node.op == "normalizer":
        x = _as_2d(vals[node.inputs[0]]).astype(np.float32)
        vals[node.outputs[0]] = Normalizer(a["norm"]).transform(x).astype(np.float32)
    elif node.op == "label_encode":
        x = np.asarray(vals[node.inputs[0]]).reshape(-1)
        vals[node.outputs[0]] = np.searchsorted(a["classes"], x)
    elif node.op == "one_hot":
        x = np.asarray(vals[node.inputs[0]]).reshape(-1)
        cats = a["categories"]
        vals[node.outputs[0]] = (x[:, None] == cats[None, :]).astype(np.float32)
    elif node.op == "concat":
        parts = [_as_2d(vals[i]).astype(np.float32) for i in node.inputs]
        vals[node.outputs[0]] = np.concatenate(parts, axis=1)
    elif node.op == "feature_extractor":
        x = _as_2d(vals[node.inputs[0]])
        vals[node.outputs[0]] = x[:, a["indices"]]
    elif node.op == "constant":
        v = np.asarray(a["value"], dtype=np.float32).reshape(1, -1)
        vals[node.outputs[0]] = np.broadcast_to(v, (n_rows, v.shape[1]))
    elif node.op == "tree_ensemble":
        ens: TreeEnsemble = a["ensemble"]
        X = _as_2d(vals[node.inputs[0]])
        score = ens.decision_function(X)
        vals[node.outputs[0]] = score
        if len(node.outputs) > 1:
            thr = a.get("decision_threshold", 0.5)
            vals[node.outputs[1]] = (score >= thr).astype(np.int64)
    elif node.op == "linear":
        X = _as_2d(vals[node.inputs[0]]).astype(np.float32)
        z = X @ a["weights"].astype(np.float32) + np.float32(a["bias"])
        if a.get("post", "none") == "logistic":
            z = 1.0 / (1.0 + np.exp(-z))
        vals[node.outputs[0]] = z
        if len(node.outputs) > 1:
            thr = a.get("decision_threshold", 0.5)
            vals[node.outputs[1]] = (z >= thr).astype(np.int64)
    elif node.op == "python_udf":
        X = _as_2d(vals[node.inputs[0]]).astype(np.float32)
        vals[node.outputs[0]] = _as_2d(
            np.asarray(a["fn"](X), dtype=np.float32)
        )
    else:
        raise ValueError(f"unknown op {node.op}")


def run_pipeline(
    pipeline: TrainedPipeline, inputs: dict[str, np.ndarray]
) -> dict[str, np.ndarray]:
    """Op-at-a-time interpreted execution (ONNX Runtime analog)."""
    n_rows = len(next(iter(inputs.values())))
    vals: dict[str, np.ndarray] = {}
    for spec in pipeline.inputs:
        vals[spec.name] = np.asarray(inputs[spec.name])
    for node in pipeline.nodes:
        _eval_node(node, vals, n_rows)
    return {o: vals[o] for o in pipeline.outputs}


def _node_label(n: PipelineNode) -> str:
    return f"{n.op}[{', '.join(n.outputs)}]"


# ---------------------------------------------------------------------------
# Pipeline construction (the "training" front-end)
# ---------------------------------------------------------------------------


def fit_pipeline(
    columns: dict[str, np.ndarray],
    label: np.ndarray,
    numeric: list[str],
    categorical: list[str],
    estimator,
    categories: Optional[dict[str, np.ndarray]] = None,
) -> TrainedPipeline:
    """Standard enterprise pipeline: scale numerics, one-hot categoricals,
    concat, model. Mirrors the paper's trained pipelines (§7 'Trained
    pipelines')."""
    from repro_torch.ml.featurizers import OneHotEncoder, StandardScaler

    nodes: list[PipelineNode] = []
    feat_parts: list[str] = []
    specs: list[InputSpec] = []

    if numeric:
        for c in numeric:
            specs.append(InputSpec(c, "numeric"))
        nodes.append(
            PipelineNode("concat", list(numeric), ["num_raw"], {})
        )
        Xnum = np.stack([columns[c] for c in numeric], axis=1).astype(np.float64)
        sc = StandardScaler().fit(Xnum)
        nodes.append(
            PipelineNode(
                "scaler",
                ["num_raw"],
                ["num_scaled"],
                {"offset": sc.offset, "scale": sc.scale},
            )
        )
        feat_parts.append("num_scaled")

    encoders: dict[str, OneHotEncoder] = {}
    for c in categorical:
        specs.append(InputSpec(c, "categorical"))
        if categories is not None and c in categories:
            enc = OneHotEncoder(categories=np.asarray(categories[c]))
        else:
            enc = OneHotEncoder().fit(columns[c])
        encoders[c] = enc
        nodes.append(
            PipelineNode(
                "one_hot", [c], [f"{c}_oh"], {"categories": enc.categories}
            )
        )
        feat_parts.append(f"{c}_oh")

    nodes.append(PipelineNode("concat", feat_parts, ["features"], {}))

    # featurize training data to fit the model
    parts = []
    if numeric:
        parts.append(sc.transform(Xnum))
    for c in categorical:
        parts.append(encoders[c].transform(columns[c]))
    X = np.concatenate(parts, axis=1)
    estimator.fit(X, label)

    if hasattr(estimator, "ensemble") and estimator.ensemble is not None:
        nodes.append(
            PipelineNode(
                "tree_ensemble",
                ["features"],
                ["score", "label"],
                {"ensemble": estimator.ensemble},
            )
        )
    else:
        nodes.append(
            PipelineNode(
                "linear",
                ["features"],
                ["score", "label"],
                {
                    "weights": estimator.weights,
                    "bias": estimator.bias,
                    "post": "logistic",
                },
            )
        )
    pipe = TrainedPipeline(inputs=specs, outputs=["score", "label"], nodes=nodes)
    pipe.toposort()
    return pipe


# ---------------------------------------------------------------------------
# (De)serialization — the on-disk "model format" (npz + json header)
# ---------------------------------------------------------------------------

try:  # orjson is an optional speedup (see requirements-optional.txt)
    import orjson as _json_impl

    def _json_dumps(obj) -> bytes:
        # OPT_SERIALIZE_NUMPY: accept numpy scalars in node attrs, matching
        # the stdlib fallback's _json_default behavior
        return _json_impl.dumps(obj, option=_json_impl.OPT_SERIALIZE_NUMPY)

    def _json_loads(data: bytes):
        return _json_impl.loads(data)

except ModuleNotFoundError:
    import json as _json_impl

    def _json_default(o):
        if isinstance(o, np.generic):
            return o.item()
        raise TypeError(f"not JSON-serializable: {type(o)}")

    def _json_dumps(obj) -> bytes:
        return _json_impl.dumps(obj, default=_json_default).encode()

    def _json_loads(data: bytes):
        return _json_impl.loads(data.decode())


def save_pipeline(pipeline: TrainedPipeline, path: str) -> None:
    arrays: dict[str, np.ndarray] = {}
    meta_nodes = []
    for i, n in enumerate(pipeline.nodes):
        attrs_meta: dict[str, Any] = {}
        for k, v in n.attrs.items():
            if isinstance(v, TreeEnsemble):
                for f in dataclasses.fields(v):
                    val = getattr(v, f.name)
                    if isinstance(val, np.ndarray):
                        arrays[f"n{i}.{k}.{f.name}"] = val
                    else:
                        attrs_meta.setdefault(f"{k}.__scalars__", {})[f.name] = val
                attrs_meta[k] = "__tree_ensemble__"
            elif isinstance(v, np.ndarray):
                arrays[f"n{i}.{k}"] = v
                attrs_meta[k] = "__array__"
            else:
                attrs_meta[k] = v
        meta_nodes.append(
            {"op": n.op, "inputs": n.inputs, "outputs": n.outputs, "attrs": attrs_meta}
        )
    meta = {
        "inputs": [[s.name, s.kind] for s in pipeline.inputs],
        "outputs": pipeline.outputs,
        "nodes": meta_nodes,
    }
    arrays["__meta__"] = np.frombuffer(_json_dumps(meta), dtype=np.uint8)
    np.savez(path, **arrays)


def load_pipeline(path: str) -> TrainedPipeline:
    """Read a pipeline written by ``save_pipeline`` (this package's or the
    reference package's: the npz + json-header format is the same)."""
    data = np.load(path, allow_pickle=False)
    meta = _json_loads(bytes(data["__meta__"].tobytes()))
    return pipeline_from_arrays(
        meta, {k: data[k] for k in data.files if k != "__meta__"}
    )


def pipeline_from_arrays(
    meta: dict[str, Any], arrays: dict[str, np.ndarray]
) -> TrainedPipeline:
    """Rebuild a pipeline from its json header (``meta``) and its named
    numpy arrays, the two halves of the ``save_pipeline`` format. This is how
    weights trained by the reference package cross over without a file."""
    nodes = []
    for i, nm in enumerate(meta["nodes"]):
        attrs: dict[str, Any] = {}
        for k, v in nm["attrs"].items():
            if k.endswith(".__scalars__"):
                continue
            if v == "__tree_ensemble__":
                scalars = nm["attrs"].get(f"{k}.__scalars__", {})
                kw = dict(scalars)
                for f in dataclasses.fields(TreeEnsemble):
                    key = f"n{i}.{k}.{f.name}"
                    if key in arrays:
                        kw[f.name] = np.asarray(arrays[key])
                attrs[k] = TreeEnsemble(**kw)
            elif v == "__array__":
                attrs[k] = np.asarray(arrays[f"n{i}.{k}"])
            else:
                attrs[k] = v
        nodes.append(PipelineNode(nm["op"], nm["inputs"], nm["outputs"], attrs))
    return TrainedPipeline(
        inputs=[InputSpec(n, k) for n, k in meta["inputs"]],
        outputs=meta["outputs"],
        nodes=nodes,
    )
