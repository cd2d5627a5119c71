"""`BENCHMARK.json` against the benchmark's contract: keys, names, units,
bounds, lengths, the files each entry names, and that every cell's
configuration is the port's own."""

import pytest

pytest.importorskip("torch")

import dataclasses
import importlib
import json
import re


from portbench import arch, bench
from portbench.tests import smoke

MANIFEST = json.loads((smoke.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and \
        "\t" not in text


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (smoke.ROOT / p).is_dir()
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(_line(w) for w in MANIFEST["command"])
    assert (smoke.ROOT / MANIFEST["command"][1]).is_file()
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43 200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_every_name_and_unit_uses_only_the_allowed_characters():
    names = [c["name"] for c in MANIFEST["configs"]]
    names += [w["name"] for w in MANIFEST["workloads"]]
    names += [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    names += [w["config"] for w in MANIFEST["workloads"]]
    names += [w["traffic"] for w in MANIFEST["workloads"]]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in MANIFEST[kind]]
        assert len(ns) == len(set(ns)), kind
    metric_names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_entries_and_their_files():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert (smoke.ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (smoke.ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (smoke.ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(
        1, len(MANIFEST["workloads"]) // 4)
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        reporting = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", reporting)) <= reporting
        assert bench.reader_path(m["name"]).is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in MANIFEST["workloads"]:
        reported = [m for m in MANIFEST["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert any(w["name"] in m.get("workloads", cells) for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda c: c["name"])
def test_each_configuration_is_the_port_s_own(entry):
    """The file builds the port's own configuration, but for the keys it
    names in `port_overrides` (set to the source's values), and `reduced`
    names exactly what the file records as changed from the source."""
    cfg = arch.read(smoke.ROOT / entry["file"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    module, attr = cfg["port_config"].rsplit(".", 1)
    built = arch.port_config(arch.sizes(cfg["arch"]))
    port = getattr(importlib.import_module(module), attr)
    differ = {f.name for f in dataclasses.fields(port) if getattr(built, f.name) != getattr(port,
                                                                                         f.name)}
    assert differ == set(cfg["port_overrides"])
    assert dataclasses.replace(port, **{k: getattr(built, k) for k in differ}) == built
    assert sorted(entry["reduced"]) == sorted(cfg["changed_from_source"])
    assert all(_line(why) for why in cfg["changed_from_source"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_each_reader_loads_and_returns_nothing_with_nothing_to_read(metric):
    assert bench.load_source(bench.reader_path(metric)).read({}) is None
