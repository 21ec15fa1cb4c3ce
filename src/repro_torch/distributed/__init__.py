"""Fault tolerance, gradient compression and collectives for the train
loop: the straggler monitor and step timer, int8 error-feedback compression
(one participant's round, or the int8 all-reduce over a mesh axis) and the
two-level gradient reduction ``hierarchical_psum``."""
from repro_torch.distributed.compression import (
    ErrorFeedbackState,
    compressed_gradient_update,
    ef_init,
    ef_int8_compress,
    ef_int8_decompress,
)
from repro_torch.distributed.straggler import StepTimer, StragglerMonitor
from repro_torch.distributed.collectives import hierarchical_psum

__all__ = [
    "ef_init",
    "ef_int8_compress",
    "ef_int8_decompress",
    "ErrorFeedbackState",
    "compressed_gradient_update",
    "StepTimer",
    "StragglerMonitor",
    "hierarchical_psum",
]
