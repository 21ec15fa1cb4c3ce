"""Launchers: the training entry point (``python -m repro_torch.launch.train``),
the device meshes (:mod:`repro_torch.launch.mesh`), the inputs' sharding
rules (:mod:`repro_torch.launch.shardings`) and the dry run (``python -m
repro_torch.launch.dryrun``, its cost analysis in
:mod:`repro_torch.launch.hlo_analysis`)."""
