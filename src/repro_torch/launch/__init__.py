"""Launch drivers of the port.  `train` is the training CLI
(`python -m repro_torch.launch.train`); the reference's dry-run, mesh,
report, rescore and roofline drivers wait for the mesh path (ROADMAP A10)."""
