"""MLtoDNN (paper §5.1): pipeline → fused tensor program for the DNN runtime.

Thin rule wrapper over :mod:`repro_torch.tensor.compile` (the Hummingbird
analog); coverage is everything the tensor compiler supports — featurizers,
linear models, tree ensembles (GEMM or gather strategy). The LPredict node's
physical lowering becomes a TensorOp whose program runs with the surrounding
relational operators in one pure stage.

Partial lowering: when a pipeline contains unsupported nodes, the rule does
not abandon the whole pipeline. :func:`compile_pipeline_to_dnn_partial`
runs the coverage/frontier split (:func:`repro_torch.ml.pipeline.split_pipeline`),
compiles the supported prefix/suffix slices to tensor programs, and leaves
only the minimal residual for the host runtime — the optimizer emits
``TensorOp(prefix) → MLUdf(residual) → TensorOp(suffix)``.
:exc:`MLtoDNNUnsupported` is raised only when nothing at all can be lowered.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.cost import CostModel, CutDecision
from repro_torch.ml.pipeline import (
    PipelineSplit,
    SplitSegment,
    TrainedPipeline,
    select_cut,
)
from repro_torch.tensor.compile import (
    TensorCompilation,
    compile_pipeline_tensor,
    tensor_supported,
)


class MLtoDNNUnsupported(Exception):
    pass


@dataclass
class PartialDNNLowering:
    """Outcome of the pipeline-splitting MLtoDNN lowering.

    One of three shapes: ``full`` set (pipeline fully supported — the
    classic single-TensorOp lowering); a split with a host ``residual``
    and compiled ``prefix``/``suffix`` tensor slices (either may be None
    when its slice is empty); or — when the cost model prices the split's
    boundary crossings above the tensor speedup — neither, with
    ``decision.choice == "monolithic"`` telling the optimizer to emit one
    host MLUdf over the whole pipeline. ``split`` carries the per-node
    placement for the optimizer's report; ``decision`` (None for fully
    supported pipelines) carries the cost comparison.
    """

    split: PipelineSplit
    full: Optional[TensorCompilation] = None
    prefix: Optional[tuple[TensorCompilation, SplitSegment]] = None
    residual: Optional[SplitSegment] = None
    suffix: Optional[tuple[TensorCompilation, SplitSegment]] = None
    decision: Optional[CutDecision] = None


def compile_pipeline_to_dnn_partial(
    pipe: TrainedPipeline,
    strategy: str = "auto",
    use_kernels: bool | None = None,
    rename: Optional[dict[str, str]] = None,
    cost_model: Optional[CostModel] = None,
    device=None,
) -> PartialDNNLowering:
    """Split-aware MLtoDNN: lower the maximal supported prefix and suffix,
    keep the minimal residual on host — unless the cost model says the
    split's boundary crossings outweigh the tensor speedup, in which case
    the decision says "monolithic" and nothing is compiled.

    ``rename`` maps pipeline graph outputs to plan column names so segment
    ``out_cols`` land directly in the engine's namespace. ``cost_model``
    defaults to a fresh :meth:`CostModel.default` (deterministic, so plan
    cache keys stay stable), and its ``rows_hint`` is the batch size the
    decision is priced at. ``device`` is where the tensor programs are
    built, as :func:`compile_pipeline_tensor` takes it (the optimizer
    builds them on ``"cpu"`` and moves them to the run's device). Raises
    :exc:`MLtoDNNUnsupported` only when neither a prefix nor a suffix can
    be lowered (the plan falls back to one monolithic MLUdf with no
    decision to make): a supported slice whose program fails to build
    raises the compiler's own error.
    """
    split, decision = select_cut(
        pipe, tensor_supported, rename=rename, cost_model=cost_model
    )
    if split.fully_supported:
        return PartialDNNLowering(
            split=split,
            # every node already passed tensor_supported: nothing to catch
            full=compile_pipeline_tensor(
                pipe, strategy=strategy, use_kernels=use_kernels, device=device
            ),
        )
    if split.prefix is None and split.suffix is None:
        raise MLtoDNNUnsupported(
            "no supported prefix or suffix to split out: "
            + ", ".join(label for label, _ in split.placement)
        )
    if decision is not None and decision.choice == "monolithic":
        return PartialDNNLowering(split=split, decision=decision)

    def _compile(seg: Optional[SplitSegment]):
        if seg is None:
            return None
        return (
            compile_pipeline_tensor(
                seg.pipeline, strategy=strategy, use_kernels=use_kernels,
                device=device,
            ),
            seg,
        )

    return PartialDNNLowering(
        split=split,
        prefix=_compile(split.prefix),
        residual=split.residual,
        suffix=_compile(split.suffix),
        decision=decision,
    )
