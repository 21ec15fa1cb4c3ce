from repro_torch.checkpoint.store import (
    CheckpointManager,
    load_checkpoint,
    restore_onto_device,
    restore_onto_mesh,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "save_checkpoint",
    "load_checkpoint",
    "restore_onto_device",
    "restore_onto_mesh",
]
