"""Fault tolerance and gradient compression for the train loop: the
straggler monitor and step timer, and int8 error-feedback compression's
single-participant round. The reference's collectives
(``hierarchical_psum``) need more than one device and are not ported
(ROADMAP Queue 1 item 10, distributed)."""
from repro_torch.distributed.compression import (
    ErrorFeedbackState,
    compressed_gradient_update,
    ef_init,
    ef_int8_compress,
    ef_int8_decompress,
)
from repro_torch.distributed.straggler import StepTimer, StragglerMonitor

__all__ = [
    "ef_init",
    "ef_int8_compress",
    "ef_int8_decompress",
    "ErrorFeedbackState",
    "compressed_gradient_update",
    "StepTimer",
    "StragglerMonitor",
]
