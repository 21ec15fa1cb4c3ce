"""Training: the reference's optimizers and step builders on PyTorch."""
from repro_torch.train.optimizer import adafactor_init, adafactor_update, adamw_init, adamw_update
from repro_torch.train.step import make_prefill_step, make_serve_step, make_train_step

__all__ = [
    "adafactor_init", "adafactor_update", "adamw_init", "adamw_update",
    "make_prefill_step", "make_serve_step", "make_train_step",
]
