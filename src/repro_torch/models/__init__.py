"""The LM model zoo on PyTorch: configs in :mod:`repro_torch.configs`,
layers, dense decoder stacks and :func:`build_model`."""
from repro_torch.models.base import ArchConfig, Shapes, active_param_count, param_count
from repro_torch.models.zoo import build_model

__all__ = ["ArchConfig", "Shapes", "active_param_count", "build_model", "param_count"]
