"""The benchmark of `repro_torch`, the PyTorch and CUDA port.

`run.py` is the entry point (`python3 portbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`); `BENCHMARK.json` at the root of
the repository names the cells, and each cell's configuration, traffic mix
and per-layer metrics are files of their own under `configs/`, `traffic/`
and `metrics/`, found by name.  Nothing here imports JAX or the JAX
package; `reference/` imports nothing of the port either.
"""
