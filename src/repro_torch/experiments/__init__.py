"""The paper's experiments on the port, each runnable on the card as
`python -m repro_torch.experiments.<name>`:

  table1_accuracy — Table I: Waveform-V2 accuracy per DR row
                    (`benchmarks/table1_accuracy.py`)
  table2_cost     — Table II: the MAC / weight-byte cost model
                    (`benchmarks/table2_cost.py`)
  ica_quality     — Amari distance of EASI vs block size
                    (`benchmarks/ica_quality.py`)
  waveform_repro  — the full Table I protocol with ablations and the
                    ideal-PCA reference (`examples/waveform_repro.py`)
  quickstart      — the technique in a few lines (`examples/quickstart.py`)
  serve_lm        — DR and LM traffic through one engine, the LM on a mesh,
                    a replicated registry with failover (`examples/serve_lm.py`)
  lm_dr_frontend  — a DR front-end co-trained in a meshed LM train step
                    (`examples/lm_dr_frontend.py`)
  roofline_table  — the dry-run sweep's roofline rows
                    (`benchmarks/roofline_table.py`; no card needed)

`run()` functions return rows in the reference's `(name, us, detail)` form.
"""
