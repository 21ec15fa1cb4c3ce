"""Hand-written CUDA kernels (``csrc/``), their wrappers, and the plain
PyTorch versions (``ref``) that the CPU path runs and the kernels are held
against. :mod:`repro_torch.kernels.ops` is the dispatch surface."""
