"""repro_torch — the DR datapath of `repro`, ported to PyTorch and CUDA.

A package beside the JAX reference, mirroring its layout file for file:

  core     — random projection, EASI, whitening, the Execution policy
  kernels  — hand-written CUDA kernels (sm_90a) and their plain versions
  dr       — Stage / RPStage / EASIStage / DRModel
  data     — the Waveform-V2 generator
  bridge   — numpy ↔ torch for model states

It imports torch, numpy and the standard library, never JAX and nothing of
`repro`.  Entry points run on the CUDA card unless the caller passes
`device="cpu"` in its `Execution`.
"""
