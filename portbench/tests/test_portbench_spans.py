"""The readers of the program's spans (`repro_torch.obs`): a traced run of
each cell on the CPU reports each of its span metrics with a positive
value, and they agree with each other and with the slice: the train step's
three phases fit in a step of the slice, and a serving step's time off the
CPU in its wall time."""

import json

import pytest

pytest.importorskip("torch")

from portbench.tests import smoke

SPAN_METRICS = {
    "hubert-xlarge-dr.train": ("forward_host_ms.train", "backward_host_ms.train",
                               "optimizer_host_ms.train"),
    "internvl2-1b-dr.prefill": ("step_host_ms.serve", "step_off_cpu_ms.serve",
                                "dr_host_ms.serve"),
    "hubert-xlarge-dr.encode": ("step_host_ms.serve", "step_off_cpu_ms.serve",
                                "dr_host_ms.serve"),
    "internvl2-1b-dr.answer": ("step_host_ms.serve", "step_off_cpu_ms.serve",
                               "dr_host_ms.serve"),
}


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_traced_run_reports_each_span_metric(cell):
    from repro_torch import obs

    obs.clear()          # the readers read the whole store
    res, _ = smoke.run(cell, trace=True, seconds=0.1)
    assert res["correct"]
    got = {m: res["metrics"][m]["value"] for m in SPAN_METRICS[cell] if m in res["metrics"]}
    assert set(got) == set(SPAN_METRICS[cell])
    assert all(v > 0 for v in got.values()), got
    if cell.endswith(".train"):
        traffic = json.loads((smoke.ROOT / "portbench" / "traffic" / "train.json").read_text())
        steps = dict(traffic, **smoke.TRAFFIC["train"])["trace_steps"]
        assert sum(got.values()) <= res["device"]["window_s"] * 1e3 / steps
    else:
        assert got["step_off_cpu_ms.serve"] <= got["step_host_ms.serve"]
