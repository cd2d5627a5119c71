"""Launch entry points of the port.  `mesh` builds the device meshes
(`make_production_mesh`, `make_smoke_mesh`); `train` is the training CLI
(`python -m repro_torch.launch.train`).  The reference's dry-run, report,
rescore and roofline tools are not ported yet (ROADMAP A13)."""
