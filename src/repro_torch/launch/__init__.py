"""Launchers: the training entry point (``python -m repro_torch.launch.train``)
and the device meshes (:mod:`repro_torch.launch.mesh`)."""
