"""repro_torch — `repro` ported to PyTorch and CUDA: the DR datapath and LM
serving over the dense transformers.

A package beside the JAX reference, mirroring its layout file for file:

  core       — random projection, EASI, whitening, the Execution policy
  kernels    — hand-written CUDA kernels (sm_90a) and their plain versions
  dr         — Stage / RPStage / EASIStage / DRModel
  data       — the Waveform-V2 generator
  models     — ArchConfig, blocks, the dense transformer, the model api
  configs    — the LM zoo's architecture configs (data only)
  serve      — the LM serving steps and their bounded cache
  checkpoint — config_hash
  bridge     — numpy ↔ torch for model states and LM parameters

It imports torch, numpy and the standard library, never JAX and nothing of
`repro`.  Entry points run on the CUDA card unless the caller passes
`device="cpu"` in its `Execution`.
"""
