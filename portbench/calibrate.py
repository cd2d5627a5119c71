"""The readings that a cell's limits are set from, in one process on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --what program,control,fault:<name> --seconds 3 --out calib.jsonl

`program` runs the cell as the benchmark does (a short window) and
records the numbers its check compares; `control` puts the reference one
step of precision below the configuration in the program's place (its
products in fp8, the front end's in TF32) and compares it with the float32
reference in the same way; `fault:<name>` runs the program with a fault
planted under the timed path (`unchanged`: the state a step returns is the
one it was given; `half_batch`: a training step sees half its rows, the
mean taken over them; `answer_altered`: a served answer is changed where it
is produced; `decode_unchanged`: each decode step hands back the cache's
state as the prefill left it, so the next writes over the same slot;
`token_altered`: a decoded token is changed where it is produced).  One
JSON line a reading, with `correct` as the cell's committed limits judge
it: the control and every fault have to come out not correct.  The readings that set a cell's limits are kept in
`readings/<cell>.jsonl`, where a test judges them again against
`limits/<cell>.json`.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def control(root: Path, name: str, seed: int, **kw):
    """The control's numbers: the reference in the next lower precision
    against the float32 reference, at the cell's own sizes.  A decode's
    positions are read along tokens drawn from the seed
    (`generate.continuation`), the same on both sides."""
    import importlib

    import torch

    from portbench import arch as arch_mod
    from portbench import bench, generate, weights

    _, _, config, traffic, _ = bench.resolve(root, name)
    traffic = dict(traffic, **kw.get("traffic_overrides", {}))
    dev = kw.get("device") or torch.device("cuda", 0)
    r = bench.Run(traffic=traffic, arch=arch_mod.sizes(config["arch"], kw.get("arch_overrides")),
                  seed=seed, seconds=0.0, trace=False, device=dev, t_start=time.perf_counter(),
                  reference=config["reference"])
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    prec = bench.reference_of(r).Precision
    low = prec(lm="fp8", dr="tf32")
    b0 = weights.draw_dr(r.arch, seed, dev)[1] if r.arch.dr_frontend is not None else None
    if traffic["driver"] == "train":
        got = driver.reference(r, low)
        return driver.compare(got, driver.reference(r, prec()), b0)
    issued = kw.get("issued", 300)
    sample = sorted({issued // 7, issued // 3, issued // 2, issued - 1})
    fed = {i: generate.continuation(seed, i, traffic, r.arch, dev) for i in sample} \
        if traffic.get("decode_steps") else {}
    answers, live, staged = driver.reference(r, low, issued, sample, fed)
    got = {"kept": {i: {"rows": red, "logits": lg,
                        "decode": None if dec is None else dec.unbind(1)}
                    for i, (red, lg, dec) in answers.items()},
           "live": live, "staged": staged}
    want = driver.reference(r, prec(), issued, sample, fed)
    update = traffic["dr"] == "serve_and_update" and b0 is not None
    return driver.compare(got, want, b0, update)


def main(argv=None) -> int:
    import torch

    from portbench import bench

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="program,control")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    limits = bench.resolve(ROOT, args.workload)[4]
    out = open(args.out, "a")
    for what in args.what.split(","):
        for seed in seeds:
            t = time.perf_counter()
            if what == "control":
                checks = dict(control(ROOT, args.workload, seed))
                extra = {"correct": bench.judge(list(checks.items()), limits)[0]}
            else:
                fault = what.split(":", 1)[1] if what.startswith("fault:") else None
                res, ch = bench.run_cell(ROOT, args.workload, seed, args.seconds, False,
                                         fault=fault, log=lambda s: None)
                checks = {k: v["value"] for k, v in ch.items()}
                extra = {"correct": res["correct"], "metrics": res["metrics"],
                         "peak": res["device"]["memory_peak_bytes"]}
            line = {"workload": args.workload, "what": what, "seed": seed, "checks": checks,
                    "seconds": time.perf_counter() - t, **extra}
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")
            out.flush()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
