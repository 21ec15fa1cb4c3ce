"""MLtoSQL (paper §5.1): compile a trained pipeline to relational expressions.

Linear models and scalers become mul/add/sub chains; trees and encoders
become (nested) CASE expressions — exactly the paper's construction. The
resulting expressions replace the LPredict node with a Project, so the whole
query runs in one pure stage of the data engine (no ML-runtime
invocation, no data conversion — the two costs the optimization removes).

Whole-pipeline-or-fail semantics, as in the paper: raises
:class:`MLtoSQLUnsupported` if any op lacks a SQL translation (e.g. l2
normalizer — needs sqrt), and the optimizer falls back to the ML runtime.

Classification scores: a logistic post-transform is monotone, so the label
compare moves to logit space (``z >= 0`` ⟺ ``sigmoid(z) >= 0.5``) and the
emitted score column is in *logit* space (``score_space`` records this).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.ml.pipeline import TrainedPipeline
from repro_torch.ml.trees import LEAF, TreeEnsemble
from repro_torch.relational.expr import Bin, Case, Col, Const, Expr


class MLtoSQLUnsupported(Exception):
    pass


@dataclass
class SQLCompilation:
    exprs: dict[str, Expr]  # graph output name -> expression
    score_space: str  # "prob" | "logit"
    size: int  # total expression node count


def _tree_to_expr(ens: TreeEnsemble, tree: int, feats: list[Expr]) -> Expr:
    """Nested-CASE for one tree, built leaves-up (no recursion)."""
    sl = ens.tree_slices()[tree]
    w = float(ens.tree_weight[tree])
    exprs: dict[int, Expr] = {}
    for i in range(sl.stop - 1, sl.start - 1, -1):
        if ens.feature[i] == LEAF:
            exprs[i] = Const(w * float(ens.leaf_value[i]))
        else:
            f = int(ens.feature[i])
            exprs[i] = Case(
                Bin("le", feats[f], Const(float(ens.threshold[i]))),
                exprs[int(ens.left[i])],
                exprs[int(ens.right[i])],
            )
    return exprs[sl.start]


def _sum(parts: list[Expr]) -> Expr:
    if not parts:
        return Const(0.0)
    e = parts[0]
    for p in parts[1:]:
        e = Bin("add", e, p)
    return e


def compile_pipeline_to_sql(pipe: TrainedPipeline) -> SQLCompilation:
    from repro_torch.relational.expr import expr_size

    vals: dict[str, list[Expr]] = {}
    for spec in pipe.inputs:
        vals[spec.name] = [Col(spec.name)]

    score_space = "prob"
    out_exprs: dict[str, Expr] = {}

    for node in pipe.nodes:
        a = node.attrs
        if node.op == "concat":
            vals[node.outputs[0]] = [e for i in node.inputs for e in vals[i]]
        elif node.op == "scaler":
            src = vals[node.inputs[0]]
            vals[node.outputs[0]] = [
                Bin(
                    "mul",
                    Bin("sub", e, Const(float(a["offset"][k]))),
                    Const(float(a["scale"][k])),
                )
                for k, e in enumerate(src)
            ]
        elif node.op == "one_hot":
            e = vals[node.inputs[0]][0]
            vals[node.outputs[0]] = [
                Case(Bin("eq", e, Const(c)), Const(1.0), Const(0.0))
                for c in np.asarray(a["categories"]).tolist()
            ]
        elif node.op == "label_encode":
            e = vals[node.inputs[0]][0]
            expr: Expr = Const(float(len(a["classes"]) - 1))
            for code, cls in reversed(list(enumerate(np.asarray(a["classes"]).tolist()))):
                expr = Case(Bin("eq", e, Const(cls)), Const(float(code)), expr)
            vals[node.outputs[0]] = [expr]
        elif node.op == "feature_extractor":
            src = vals[node.inputs[0]]
            vals[node.outputs[0]] = [src[int(i)] for i in a["indices"]]
        elif node.op == "constant":
            v = np.atleast_1d(np.asarray(a["value"], dtype=np.float64))
            vals[node.outputs[0]] = [Const(float(x)) for x in v]
        elif node.op == "normalizer":
            if a["norm"] == "l2":
                raise MLtoSQLUnsupported("l2 normalizer needs sqrt")
            src = vals[node.inputs[0]]
            absd = [Bin("max", e, Bin("sub", Const(0.0), e)) for e in src]
            denom = _sum(absd) if a["norm"] == "l1" else _max_chain(absd)
            vals[node.outputs[0]] = [Bin("div", e, denom) for e in src]
        elif node.op == "tree_ensemble":
            ens: TreeEnsemble = a["ensemble"]
            feats = vals[node.inputs[0]]
            score = _sum(
                [Const(ens.base_score)]
                + [_tree_to_expr(ens, t, feats) for t in range(ens.n_trees)]
            )
            thr = float(a.get("decision_threshold", 0.5))
            if ens.post_transform == "logistic":
                score_space = "logit"
                cut = 0.0 if thr == 0.5 else float(np.log(thr / (1 - thr)))
            else:
                cut = thr
            out_exprs[node.outputs[0]] = score
            if len(node.outputs) > 1:
                out_exprs[node.outputs[1]] = Case(
                    Bin("ge", score, Const(cut)), Const(1), Const(0)
                )
        elif node.op == "linear":
            feats = vals[node.inputs[0]]
            w = np.asarray(a["weights"], dtype=np.float64)
            terms = [
                Bin("mul", feats[k], Const(float(w[k])))
                for k in range(len(w))
                if w[k] != 0.0  # zero weights never touch the data
            ]
            score = _sum(terms + [Const(float(a["bias"]))])
            thr = float(a.get("decision_threshold", 0.5))
            if a.get("post", "none") == "logistic":
                score_space = "logit"
                cut = 0.0 if thr == 0.5 else float(np.log(thr / (1 - thr)))
            else:
                cut = thr
            out_exprs[node.outputs[0]] = score
            if len(node.outputs) > 1:
                out_exprs[node.outputs[1]] = Case(
                    Bin("ge", score, Const(cut)), Const(1), Const(0)
                )
        else:
            raise MLtoSQLUnsupported(node.op)

    missing = [o for o in pipe.outputs if o not in out_exprs]
    if missing:
        raise MLtoSQLUnsupported(f"outputs {missing} not produced by a model op")
    exprs = {o: out_exprs[o] for o in pipe.outputs}
    size = sum(expr_size(e) for e in exprs.values())
    return SQLCompilation(exprs=exprs, score_space=score_space, size=size)


def _max_chain(parts: list[Expr]) -> Expr:
    e = parts[0]
    for p in parts[1:]:
        e = Bin("max", e, p)
    return e
