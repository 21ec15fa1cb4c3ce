"""Compile a TrainedPipeline into one fused tensor program.

This is the MLtoDNN target (paper §5.1, via Hummingbird): featurizers become
vectorized torch ops, tree ensembles become GEMM or gather-traversal programs
(strategy picked per ensemble and per device), and the whole pipeline is one
:class:`TensorProgram`, an ``nn.Module`` whose constants (scaler offsets and
scales, category values, the padded GEMM and traversal arrays) are buffers
built and moved to the device once, at compile time.

For CUDA tensors the fused featurize chain and the GEMM tree step run the
hand-written kernels of :mod:`repro_torch.kernels`; on the CPU they run the
plain versions (same math).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.ml.pipeline import TrainedPipeline
from repro_torch.ml.trees import TreeEnsemble
from repro_torch.tensor.tree2tensor import (
    GemmTreeProgram,
    TraversalTreeProgram,
    build_gemm_program,
    build_traversal_program,
    gemm_predict,
    traversal_predict,
)


@dataclass
class TensorCompilation:
    fn: "TensorProgram"  # cols -> cols
    strategy: dict[str, str]  # model output name -> tree strategy on its device
    n_ops: int
    # columns the fused program consumes — surfaced so the StageGraph can
    # infer schema through an otherwise-opaque TensorOp
    input_names: tuple[str, ...] = ()
    # values produced by a scaler/one-hot/concat chain collapsed into the
    # fused featurize kernel (its plain version on the CPU)
    fused: tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# Coverage predicate
# ---------------------------------------------------------------------------

_SUPPORTED_OPS = frozenset(
    {
        "concat",
        "scaler",
        "one_hot",
        "label_encode",
        "feature_extractor",
        "constant",
        "normalizer",
        "tree_ensemble",
        "linear",
    }
)


def tensor_supported(node) -> bool:
    """Can this pipeline node run in the tensor runtime?

    Unknown ops (e.g. ``python_udf`` — an opaque host callable) are out, as
    are encoders over string/object categories: numpy compares strings fine
    on host, but a tensor program cannot hold them. These are exactly the nodes
    the split analysis routes to the host residual.
    """
    if node.op not in _SUPPORTED_OPS:
        return False
    if node.op == "one_hot":
        return np.asarray(node.attrs["categories"]).dtype.kind not in "OUSV"
    if node.op == "label_encode":
        return np.asarray(node.attrs["classes"]).dtype.kind not in "OUSV"
    return True


# ---------------------------------------------------------------------------
# Fused-featurize targeting: scaler/one-hot/concat chains -> featurize kernel
# ---------------------------------------------------------------------------


def _detect_featurize_fusions(pipe: TrainedPipeline):
    """Find concat nodes whose whole input chain is the standard featurize
    pattern — ``concat(scaler(concat(numerics)), one_hot(c1), ...)`` over
    graph inputs — and describe each as one fused kernel call.

    Returns ``(fusions, swallowed)``: ``fusions`` maps the id() of each
    fusable final concat node to its kernel arguments; ``swallowed`` holds
    the ids of chain members replaced by the fused step. Intermediates must
    be single-consumer and not graph outputs, so fusing never orphans a
    value. The numeric part, when present, must be the concat's first input
    (the kernel emits numerics-first layout).
    """
    graph_inputs = {s.name for s in pipe.inputs}
    producer = {o: n for n in pipe.nodes for o in n.outputs}
    n_consumers: dict[str, int] = {}
    for n in pipe.nodes:
        for v in n.inputs:
            n_consumers[v] = n_consumers.get(v, 0) + 1
    out_set = set(pipe.outputs)

    def _single_use_intermediate(v: str) -> bool:
        return n_consumers.get(v, 0) == 1 and v not in out_set

    fusions: dict[int, dict] = {}
    swallowed: set[int] = set()
    for node in pipe.nodes:
        if node.op != "concat" or not node.inputs or id(node) in swallowed:
            continue
        numeric: list[str] = []
        offset = scale = None
        cat_cols: list[str] = []
        cat_vals: list[np.ndarray] = []
        segments: list[tuple[int, int]] = []
        members: list = []
        start = 0
        ok = True
        for pos, v in enumerate(node.inputs):
            p = producer.get(v)
            if p is None or not _single_use_intermediate(v):
                ok = False
                break
            if p.op == "scaler" and pos == 0 and not numeric:
                src = producer.get(p.inputs[0])
                if (
                    src is None
                    or src.op != "concat"
                    or not _single_use_intermediate(p.inputs[0])
                    or not src.inputs
                    or any(c not in graph_inputs or c in producer for c in src.inputs)
                ):
                    ok = False
                    break
                offset = np.asarray(p.attrs["offset"], np.float32).reshape(-1)
                scale = np.asarray(p.attrs["scale"], np.float32).reshape(-1)
                if offset.shape[0] != len(src.inputs):
                    ok = False
                    break
                numeric = list(src.inputs)
                members += [src, p]
            elif p.op == "one_hot":
                src_col = p.inputs[0]
                cats = np.asarray(p.attrs["categories"])
                if (
                    src_col not in graph_inputs
                    or src_col in producer
                    or cats.dtype.kind not in "iu"
                ):
                    ok = False
                    break
                segments.append((start, int(cats.shape[0])))
                start += int(cats.shape[0])
                cat_vals.append(cats.astype(np.int32))
                cat_cols.append(src_col)
                members.append(p)
            else:
                ok = False
                break
        if not ok or len(members) < 2:
            continue
        fusions[id(node)] = {
            "numeric": tuple(numeric),
            "offset": offset if offset is not None else np.zeros(0, np.float32),
            "scale": scale if scale is not None else np.zeros(0, np.float32),
            "categorical": tuple(cat_cols),
            "cat_values": (
                np.concatenate(cat_vals)
                if cat_vals
                else np.zeros(0, np.int32)
            ),
            "segments": tuple(segments),
            "out": node.outputs[0],
        }
        swallowed.update(id(m) for m in members)
    return fusions, swallowed


GEMM_MAX_INTERNAL = 128  # internal nodes per tree the GEMM strategy takes
GEMM_ALIGN = 8  # pad_gemm_program alignment for the CUDA kernel


def _max_internal(ens: TreeEnsemble) -> int:
    """The reference's count of internal nodes of the largest tree."""
    return (max(sl.stop - sl.start for sl in ens.tree_slices()) + 1) // 2


def _choose_tree_strategy(max_internal: int, device: torch.device) -> str:
    """The port's own policy (the reference picks traversal on every
    non-TPU backend): on CUDA, GEMM through the ``tree_gemm`` kernel when the
    trees have at most ``GEMM_MAX_INTERNAL`` internal nodes, else gather
    traversal; on the CPU, traversal, as the reference does there (the dense
    GEMM work loses to O(depth) gather-stepping on a CPU). A program
    compiled with ``strategy="auto"`` applies it on every call, to the
    device its input is on."""
    if device.type == "cuda" and max_internal <= GEMM_MAX_INTERNAL:
        return "gemm"
    return "traversal"


class TensorProgram(nn.Module):
    """One compiled pipeline: ``forward(cols) -> {output: tensor}``.

    ``steps`` is the pipeline in topological order with fused featurize
    chains collapsed; each step's constants are registered buffers, so
    ``.to(device)`` moves the whole program once. ``use_kernels`` keeps the
    reference's ``use_pallas`` meaning: ``None`` (or True) sends CUDA
    tensors to the kernels, ``False`` runs the plain torch composition.
    """

    def __init__(self, pipe: TrainedPipeline, steps: list, use_kernels):
        super().__init__()
        self.input_names = tuple(pipe.input_names())
        self.outputs = tuple(pipe.outputs)
        self.use_kernels = use_kernels
        self.steps: list[tuple] = []
        for kind, node, info in steps:
            self.steps.append((kind, node, self._register(kind, node, info)))

    def _buf(self, value, dtype) -> str:
        name = f"b{len(self._buffers)}"
        self.register_buffer(name, torch.as_tensor(np.asarray(value), dtype=dtype))
        return name

    def _register(self, kind, node, info) -> dict:
        a = node.attrs
        f32 = torch.float32
        if kind == "featurize":
            from repro_torch.kernels.featurize import segment_columns

            out = dict(info)
            out["offset"] = self._buf(info["offset"], f32)
            out["scale"] = self._buf(info["scale"], f32)
            out["cat_values"] = self._buf(info["cat_values"], torch.int32)
            name = f"b{len(self._buffers)}"
            self.register_buffer(name, segment_columns(info["segments"]))
            out["val_col"] = name
            return out
        if kind == "trees":  # the forms this ensemble may run in
            out = {"strategy": info["strategy"], "max_internal": info["max_internal"]}
            for form in ("gemm", "traversal"):
                if info[form] is not None:
                    out[form] = self._register(form, node, info[form])
            return out
        if kind == "gemm":
            from repro_torch.kernels.ops import pad_gemm_program
            from repro_torch.kernels.tree_gemm import pack_gemm_program

            # padded and packed once here: the reference pads inside its
            # traced closure (jit runs that once); eager torch would redo it
            # every call
            A, B, C, D, V = pad_gemm_program(
                info.A, info.B, info.C, info.Dcount, info.V, align=GEMM_ALIGN
            )
            return {
                "A": self._buf(A, f32), "B": self._buf(B, f32),
                "C": self._buf(C, f32), "D": self._buf(D, f32),
                "V": self._buf(V, f32), "base": info.base, "post": info.post,
                "n_features": info.n_features,
                "packed": tuple(self._buf(a, torch.int32)
                                for a in pack_gemm_program(A, B, C, D, V)),
            }
        if kind == "traversal":
            return {
                "feature": self._buf(info.feature, torch.int64),
                "threshold": self._buf(info.threshold, f32),
                "left": self._buf(info.left, torch.int64),
                "right": self._buf(info.right, torch.int64),
                "leaf_value": self._buf(info.leaf_value, f32),
                "max_depth": info.max_depth, "base": info.base,
                "post": info.post, "n_features": info.n_features,
            }
        if kind == "scaler":
            return {"offset": self._buf(a["offset"], f32),
                    "scale": self._buf(a["scale"], f32)}
        if kind == "one_hot":
            return {"categories": self._buf(a["categories"], None)}
        if kind == "label_encode":
            return {"classes": self._buf(a["classes"], None)}
        if kind == "feature_extractor":
            return {"indices": self._buf(np.asarray(a["indices"]), torch.int64)}
        if kind == "constant":
            v = np.atleast_1d(np.asarray(a["value"], np.float32))
            return {"value": self._buf(v, f32)}
        if kind == "linear":
            return {"weights": self._buf(a["weights"], f32)}
        return {}

    def forward(self, cols: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        b = self._buffers
        vals: dict[str, torch.Tensor] = {}
        for name in self.input_names:
            x = cols[name]
            vals[name] = x[:, None] if x.dim() == 1 else x
        n = next(iter(vals.values())).shape[0] if vals else 0
        dev = next(iter(vals.values())).device if vals else None
        for kind, node, info in self.steps:
            a = node.attrs
            if kind == "featurize":
                from repro_torch.kernels import ops
                from repro_torch.kernels.ref import featurize_ref

                # the columns as they lie: the kernel reads them in place
                num = [vals[c] for c in info["numeric"]]
                cat = [vals[c] for c in info["categorical"]]
                consts = (b[info["offset"]], b[info["scale"]],
                          b[info["cat_values"]], info["segments"])
                if self.use_kernels is False:
                    vals[info["out"]] = featurize_ref(
                        ops.stack_columns(num, n, torch.float32, dev),
                        ops.stack_columns(cat, n, torch.int32, dev), *consts,
                    )
                else:
                    vals[info["out"]] = ops.featurize_op(
                        num, cat, *consts, val_col=b[info["val_col"]]
                    )
            elif kind == "concat":
                vals[node.outputs[0]] = torch.cat(
                    [vals[i].to(torch.float32) for i in node.inputs], 1
                )
            elif kind == "scaler":
                x = vals[node.inputs[0]].to(torch.float32)
                vals[node.outputs[0]] = (x - b[info["offset"]]) * b[info["scale"]]
            elif kind == "one_hot":
                x = vals[node.inputs[0]].reshape(-1)
                cats = b[info["categories"]]
                vals[node.outputs[0]] = (x[:, None] == cats[None, :]).to(torch.float32)
            elif kind == "label_encode":
                x = vals[node.inputs[0]].reshape(-1)
                classes = b[info["classes"]]
                vals[node.outputs[0]] = torch.searchsorted(
                    classes, x.to(classes.dtype)
                ).to(torch.int32)[:, None]
            elif kind == "feature_extractor":
                vals[node.outputs[0]] = vals[node.inputs[0]][:, b[info["indices"]]]
            elif kind == "constant":
                v = b[info["value"]][None, :]
                vals[node.outputs[0]] = v.expand(n, v.shape[1])
            elif kind == "normalizer":
                x = vals[node.inputs[0]].to(torch.float32)
                if a["norm"] == "l1":
                    d = x.abs().sum(dim=1, keepdim=True)
                elif a["norm"] == "l2":
                    d = torch.sqrt((x * x).sum(dim=1, keepdim=True))
                else:
                    d = x.abs().amax(dim=1, keepdim=True)
                vals[node.outputs[0]] = x / torch.where(d == 0.0, 1.0, d)
            elif kind == "trees":
                X = vals[node.inputs[0]].to(torch.float32)
                strat = info["strategy"]
                if strat == "auto":
                    strat = _choose_tree_strategy(info["max_internal"], X.device)
                if strat == "gemm":
                    g = info["gemm"]
                    prog = GemmTreeProgram(
                        A=b[g["A"]], B=b[g["B"]], C=b[g["C"]],
                        Dcount=b[g["D"]], V=b[g["V"]], base=g["base"],
                        post=g["post"], n_features=g["n_features"],
                    )
                    if self.use_kernels is False:
                        raw = gemm_predict(prog, X)
                    else:
                        from repro_torch.kernels.ops import tree_gemm_op
                        from repro_torch.kernels.tree_gemm import PackedGemmProgram

                        raw = tree_gemm_op(
                            X, prog.A, prog.B, prog.C, prog.Dcount, prog.V,
                            base=prog.base,
                            packed=PackedGemmProgram(*(b[n] for n in g["packed"])),
                        )
                else:
                    g = info["traversal"]
                    prog = TraversalTreeProgram(
                        feature=b[g["feature"]], threshold=b[g["threshold"]],
                        left=b[g["left"]], right=b[g["right"]],
                        leaf_value=b[g["leaf_value"]],
                        max_depth=g["max_depth"], base=g["base"],
                        post=g["post"], n_features=g["n_features"],
                    )
                    raw = traversal_predict(prog, X)
                score = (
                    1.0 / (1.0 + torch.exp(-raw)) if prog.post == "logistic" else raw
                )
                thr = float(a.get("decision_threshold", 0.5))
                vals[node.outputs[0]] = score
                if len(node.outputs) > 1:
                    vals[node.outputs[1]] = (score >= thr).to(torch.int32)
            elif kind == "linear":
                X = vals[node.inputs[0]].to(torch.float32)
                z = X @ b[info["weights"]] + float(np.float32(a["bias"]))
                if a.get("post", "none") == "logistic":
                    z = 1.0 / (1.0 + torch.exp(-z))
                thr = float(a.get("decision_threshold", 0.5))
                vals[node.outputs[0]] = z
                if len(node.outputs) > 1:
                    vals[node.outputs[1]] = (z >= thr).to(torch.int32)
            else:
                raise ValueError(kind)
        return {o: vals[o] for o in self.outputs}


def compile_pipeline_tensor(
    pipe: TrainedPipeline,
    strategy: str = "auto",
    use_kernels: bool | None = None,
    device=None,
) -> TensorCompilation:
    """Compile ``pipe`` into a :class:`TensorProgram` on ``device`` (default
    ``"cuda"``). ``strategy`` forces ``"gemm"`` or ``"traversal"`` for every
    tree ensemble; ``"auto"`` keeps every form the per-device policy may
    pick, and the program picks on each call, so it stays right when
    ``.to()`` moves it. The returned ``strategy`` map is what it takes on
    ``device``."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    # eager coverage validation: reject unsupported pipelines at compile
    # time, not at first call
    bad = sorted({n.op for n in pipe.nodes if not tensor_supported(n)})
    if bad:
        raise ValueError(f"unsupported for tensor lowering: {', '.join(bad)}")

    fusions, swallowed = _detect_featurize_fusions(pipe)
    steps: list[tuple] = []  # (kind, node, info) in topo order
    chosen: dict[str, str] = {}
    fused_outs: list[str] = []
    for node in pipe.nodes:
        if id(node) in swallowed:
            continue
        if id(node) in fusions:
            steps.append(("featurize", node, fusions[id(node)]))
            fused_outs.append(node.outputs[0])
        elif node.op == "tree_ensemble":
            ens = node.attrs["ensemble"]
            m = _max_internal(ens)
            if strategy == "auto":
                chosen[node.outputs[0]] = _choose_tree_strategy(m, dev)
                forms = {"traversal"}
                if m <= GEMM_MAX_INTERNAL:
                    forms.add("gemm")
            else:
                chosen[node.outputs[0]] = strategy
                forms = {strategy}
            steps.append(("trees", node, {
                "strategy": strategy, "max_internal": m,
                "gemm": build_gemm_program(ens) if "gemm" in forms else None,
                "traversal": (
                    build_traversal_program(ens) if "traversal" in forms else None
                ),
            }))
        else:
            steps.append((node.op, node, None))

    program = TensorProgram(pipe, steps, use_kernels).to(dev)
    # canonical content token: the program is a pure function of the
    # pipeline + compilation choices, so plans embedding it (TensorOp)
    # fingerprint stably across objects and processes instead of by id()
    from repro_torch.core.fingerprint import fingerprint as _fingerprint

    program.__fingerprint_token__ = _fingerprint(
        "tensor_compile", "rt1", pipe, strategy, use_kernels,
        GEMM_MAX_INTERNAL, tuple(fused_outs),
    )
    program.__input_names__ = program.input_names
    return TensorCompilation(
        fn=program, strategy=chosen, n_ops=len(steps),
        input_names=program.input_names, fused=tuple(fused_outs),
    )


# ---------------------------------------------------------------------------
# Relational kernel emission (targeted by the Join / Aggregate stage steps)
# ---------------------------------------------------------------------------
#
# The stage IR (exec/stages.py) decides *where* a Join or Filter→Aggregate
# chain sits in a pure stage; these helpers decide *how* it lowers — the
# gather-join / masked segmented-aggregate ops when shapes qualify, the
# legacy torch composition otherwise. The upstream filter's validity mask is
# threaded in as the kernel mask, so Filter→Join and Filter→Aggregate chains
# fuse without materializing filtered rows.

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def join_kernel_qualifies(plan, dim, fk, ds) -> bool:
    """Can this Join lower to the gather-join kernel? Requires the engine's
    baked dim-sort entry with its uniqueness marker (the gather needs unique
    dim keys), integer keys on both sides, f32 payload columns, and at
    least one payload column to gather."""
    if ds is None or "unique" not in ds:
        return False
    if not plan.dim_columns:
        return False
    keys = dim[plan.dim_key]
    if keys.dtype not in _INT_DTYPES or fk.dtype not in _INT_DTYPES:
        return False
    return all(dim[c].dtype == torch.float32 for c in plan.dim_columns)


def emit_join_kernel(plan, dim, fk, ds):
    """Run the gather-join op for a qualifying Join. Returns
    ``(brought, hit)``: the gathered dim columns (zero where the key
    missed) and the per-row hit mask to AND into row validity. The sorted
    payload, and where the dimsort entry has a direct-address index the
    kernel's dense records, are built on the first call for these payload
    columns and kept in the entry."""
    from repro_torch.kernels.ops import gather_join_op
    from repro_torch.kernels.relational import dense_records

    from repro_torch.device import refuse_in_capture
    from repro_torch.exec.stages import DIMSORT_CACHE

    payloads = ds.setdefault(DIMSORT_CACHE, {})
    cols = tuple(plan.dim_columns)
    if cols not in payloads:
        refuse_in_capture("building the join's sorted payload and records")
        order = ds["order"]
        spay = torch.stack([dim[c][order] for c in cols], dim=1).to(torch.float32)
        records = dense_records(ds["index"], spay) if "index" in ds else None
        payloads[cols] = (spay, records)
    spay, records = payloads[cols]
    dense = {} if records is None else {"records": records, "lo": ds["lo"]}
    gathered, hit = gather_join_op(
        fk.to(torch.int32), ds["keys"].to(torch.int32), spay, **dense
    )
    brought = {c: gathered[:, j] for j, c in enumerate(cols)}
    return brought, hit


def emit_aggregate_kernel(aggs, cols, w, sid, num_segments):
    """Run one masked segmented-aggregate op covering every agg of an
    Aggregate op (sum/mean/count share one pass; min/max ride along). ``w``
    is the fused filter/validity mask; ``sid`` is None for a single segment.
    The value columns go to the op as they are (the kernel reads them in
    place)."""
    from repro_torch.kernels.ops import segment_agg_op

    src: list[str] = []
    for _, op, col in aggs:
        if op != "count" and col not in src:
            src.append(col)
    counts, sums, mins, maxs = segment_agg_op(
        [cols[c].to(torch.float32) for c in src], w, sid,
        num_segments=num_segments,
    )
    idx = {c: j for j, c in enumerate(src)}
    zero = counts.new_zeros(())
    out = {}
    for name, op, col in aggs:
        if op == "count":
            out[name] = counts
        elif op == "sum":
            out[name] = sums[:, idx[col]]
        elif op == "mean":
            out[name] = sums[:, idx[col]] / torch.clamp(counts, min=1.0)
        elif op == "min":
            out[name] = torch.where(counts > 0, mins[:, idx[col]], zero)
        elif op == "max":
            out[name] = torch.where(counts > 0, maxs[:, idx[col]], zero)
        else:
            raise ValueError(op)
    return out
