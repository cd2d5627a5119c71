"""Launch entry points of the port.  `mesh` builds the device meshes
(`make_production_mesh`, `make_smoke_mesh`); `train` is the training CLI
(`python -m repro_torch.launch.train`); `dryrun` builds every (arch × shape
× mesh) cell's step on fake tensors over a fake process group and prices it
with `roofline` (H100 data-sheet figures); `report` prints its tables and
`rescore` re-prices its JSONs."""
