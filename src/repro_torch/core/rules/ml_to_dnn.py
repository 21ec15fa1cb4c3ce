"""MLtoDNN (paper §5.1): pipeline → fused tensor program for the DNN runtime.

Thin rule wrapper over :mod:`repro_torch.tensor.compile` (the Hummingbird
analog); coverage is everything the tensor compiler supports — featurizers,
linear models, tree ensembles (GEMM or gather strategy). The LPredict node's
physical lowering becomes a TensorOp whose program runs with the surrounding
relational operators in one pure stage.

Whole-pipeline lowering only: the reference's pipeline-splitting lowering
(prefix TensorOp → host MLUdf → suffix TensorOp) is not ported yet.
"""
from __future__ import annotations

from repro_torch.ml.pipeline import TrainedPipeline
from repro_torch.tensor.compile import TensorCompilation, compile_pipeline_tensor


class MLtoDNNUnsupported(Exception):
    pass


def compile_pipeline_to_dnn(
    pipe: TrainedPipeline,
    strategy: str = "auto",
    use_kernels: bool | None = None,
    device=None,
) -> TensorCompilation:
    """Whole-pipeline compilation (raises on any unsupported node)."""
    try:
        return compile_pipeline_tensor(
            pipe, strategy=strategy, use_kernels=use_kernels, device=device
        )
    except (ValueError, KeyError) as e:  # unsupported op kinds
        raise MLtoDNNUnsupported(str(e)) from e
