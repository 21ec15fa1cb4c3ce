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


# ---------------------------------------------------------------------------
# Coverage/frontier analysis: split a partially-supported pipeline
# ---------------------------------------------------------------------------
#
# MLtoDNN used to be whole-pipeline-or-fail: one unsupported node and the
# entire pipeline fell back to a host MLUdf. The split analysis instead cuts
# the DAG into three standalone pipelines:
#
#   prefix   — the maximal supported slice reachable from the graph inputs
#              without passing through an unsupported node (lowered to the
#              tensor runtime),
#   residual — the minimal host slice: every unsupported node plus any
#              supported node sandwiched between unsupported ones,
#   suffix   — supported nodes all of whose consumers already sit in the
#              suffix (lowered back to the tensor runtime after the host
#              residual).
#
# Values crossing a segment boundary become reserved "block" columns named
# ``__pv_<value>`` (2-D (N,k) arrays threaded through the relational engine
# like any other column and dropped by their last consumer); graph outputs
# keep their query-visible names via the ``rename`` map.

SEGMENTS = ("prefix", "residual", "suffix")
_SEG_RANK = {s: i for i, s in enumerate(SEGMENTS)}


def cut_column(value: str) -> str:
    """Reserved column name for a pipeline value crossing a split boundary."""
    return f"__pv_{value}"


@dataclass
class SplitSegment:
    """One slice of a split pipeline, ready for plan emission.

    ``out_cols`` are the engine column names aligned 1:1 with
    ``pipeline.outputs``; ``consumes`` are upstream block columns this
    segment is the last consumer of (the plan node drops them).
    """

    pipeline: TrainedPipeline
    out_cols: list[str]
    consumes: list[str]


@dataclass
class PipelineSplit:
    prefix: Optional[SplitSegment]
    residual: Optional[SplitSegment]
    suffix: Optional[SplitSegment]
    # (node label, segment) per original node, topo order — the optimizer's
    # per-node runtime-placement annotation
    placement: list[tuple[str, str]]

    @property
    def fully_supported(self) -> bool:
        return self.residual is None


def _node_label(n: PipelineNode) -> str:
    return f"{n.op}[{', '.join(n.outputs)}]"


def split_pipeline(
    pipe: TrainedPipeline,
    supported,
    rename: Optional[dict[str, str]] = None,
) -> PipelineSplit:
    """Cut ``pipe`` into prefix/residual/suffix around ``supported``.

    ``supported(node) -> bool`` is the target runtime's coverage predicate;
    ``rename`` maps graph outputs to their engine column names (plan
    ``output_names``). Each returned segment is a standalone
    :class:`TrainedPipeline` executable by :func:`run_pipeline` (residual)
    or any pipeline compiler (prefix/suffix).
    """
    rename = dict(rename or {})
    nodes = pipe.nodes
    produced: dict[str, int] = {}
    for i, n in enumerate(nodes):
        for o in n.outputs:
            produced[o] = i
    consumers_idx: dict[str, list[int]] = {
        v: [j for j, m in enumerate(nodes) if v in m.inputs] for v in produced
    }

    # taint: unsupported, or transitively fed by a tainted node
    tainted = [False] * len(nodes)
    for i, n in enumerate(nodes):
        dep = any(tainted[produced[v]] for v in n.inputs if v in produced)
        tainted[i] = dep or not supported(n)
    if not any(tainted):
        return PipelineSplit(
            None, None, None, [(_node_label(n), "prefix") for n in nodes]
        )

    # suffix closure (reverse topo): a supported tainted node re-enters the
    # tensor runtime iff everything it feeds already has
    in_suffix = [False] * len(nodes)
    for i in reversed(range(len(nodes))):
        n = nodes[i]
        if tainted[i] and supported(n):
            in_suffix[i] = all(
                in_suffix[j]
                for o in n.outputs
                for j in consumers_idx.get(o, [])
            )
    seg_of = [
        "prefix" if not tainted[i] else ("suffix" if in_suffix[i] else "residual")
        for i in range(len(nodes))
    ]
    seg_rank = [_SEG_RANK[s] for s in seg_of]

    graph_inputs = {s.name for s in pipe.inputs}
    spec_of = {s.name: s for s in pipe.inputs}
    out_set = set(pipe.outputs)

    def _crossing(v: str) -> bool:
        pi = produced[v]
        return any(seg_rank[j] > seg_rank[pi] for j in consumers_idx.get(v, []))

    colname: dict[str, str] = {}
    last_rank: dict[str, int] = {}
    for v in produced:
        if v in out_set:
            colname[v] = rename.get(v, v)
        elif _crossing(v):
            colname[v] = cut_column(v)
            last_rank[v] = max(seg_rank[j] for j in consumers_idx[v])

    segments: dict[str, Optional[SplitSegment]] = {}
    for seg in SEGMENTS:
        idxs = [i for i, s in enumerate(seg_of) if s == seg]
        if not idxs:
            segments[seg] = None
            continue
        here = {o for i in idxs for o in nodes[i].outputs}
        sub_nodes = []
        specs: list[InputSpec] = []
        seen: set[str] = set()
        consumes: list[str] = []
        for i in idxs:
            n = nodes[i].copy()
            renamed_inputs = []
            for v in n.inputs:
                if v in produced and seg_of[produced[v]] != seg:
                    renamed_inputs.append(colname[v])
                else:
                    renamed_inputs.append(v)
            for orig, name in zip(n.inputs, renamed_inputs):
                if orig in here or name in seen:
                    continue
                seen.add(name)
                if orig in produced:  # an earlier segment's block column
                    specs.append(InputSpec(name, "block"))
                    if orig not in out_set and last_rank[orig] == _SEG_RANK[seg]:
                        consumes.append(name)
                else:
                    specs.append(dataclasses.replace(spec_of[orig]))
            n.inputs = renamed_inputs
            sub_nodes.append(n)
        outs_vals = []
        for i in idxs:
            for o in nodes[i].outputs:
                if o in colname and o not in outs_vals:
                    outs_vals.append(o)
        sub = TrainedPipeline(inputs=specs, outputs=outs_vals, nodes=sub_nodes)
        segments[seg] = SplitSegment(
            pipeline=sub,
            out_cols=[colname[v] for v in outs_vals],
            consumes=consumes,
        )
    return PipelineSplit(
        prefix=segments["prefix"],
        residual=segments["residual"],
        suffix=segments["suffix"],
        placement=[(_node_label(n), seg_of[i]) for i, n in enumerate(nodes)],
    )


def select_cut(
    pipeline: TrainedPipeline,
    supported,
    rename: dict[str, str] | None = None,
    cost_model=None,
    rows: int | None = None,
):
    """Cost-based cut selection: ``split_pipeline`` generates the structural
    (coverage-maximizing) cut, and a :class:`repro_torch.core.cost.CostModel`
    judges it against the monolithic host lowering — the only other shape
    the verifier's ``residual-minimal`` rule admits. Returns
    ``(PipelineSplit, CutDecision | None)``; the decision is ``None`` when
    the pipeline is fully supported (nothing to trade off — there is no
    host boundary to price)."""
    split = split_pipeline(pipeline, supported, rename=rename)
    if split.fully_supported:
        return split, None
    from repro_torch.core.cost import CostModel

    model = cost_model if cost_model is not None else CostModel.default()
    decision = model.choose_cut(split, pipeline.nodes, rows=rows)
    return split, decision


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
