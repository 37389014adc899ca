"""Every file the benchmark finds by name loads, and BENCHMARK.json
names only what exists."""

import json
import re

import pytest

from wam_bench import harness, stats

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_spec_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["wam_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_loads(entry):
    cfg = json.loads((harness.CHECKOUT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert entry["reduced"] == []
    assert harness.load_json("configs", entry["name"]) == cfg
    assert (harness.ROOT / "reference" / f"{cfg['reference']}.py").is_file()


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_loads(cell):
    assert NAME.match(cell["name"]) and cell["chips"] == 1
    assert len(cell["why"]) <= 200
    harness.load_json("configs", cell["config"])
    mix = harness.load_json("traffic", cell["traffic"])
    drv = harness.load_driver(mix["driver"])
    assert hasattr(drv, "Driver") and drv.FAULTS and drv.CONTROLS
    e2e = harness.cell_metrics(SPEC, cell["name"], False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(SPEC, cell["name"], True)


METRICS = [m for m in SPEC["end_to_end"] + SPEC["per_layer"]
           if m["name"] != "setup_s"]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_loads(metric):
    assert NAME.match(metric["name"])
    reader = harness.load_reader(metric["name"])
    assert reader.read({"window_s": 1.0}) is None   # nothing to read


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_moves_a_reported_metric(metric):
    for cell in metric["workloads"]:
        names = {m["name"] for m in harness.cell_metrics(SPEC, cell, False)}
        assert metric["moves"] in names


@pytest.mark.parametrize("kernel", ["k1", "k1csum", "k2", "k3"])
def test_kernel_table_loads(kernel):
    table = stats.kernel_table(kernel)
    assert re.compile(table["match"])
    for shape in table["shapes"].values():
        assert shape["bytes"] > 0 and shape["ops"] > 0
        assert str(shape["bytes"]) in shape["bytes_arithmetic"]
        assert str(shape["ops"]) in shape["ops_arithmetic"]


@pytest.mark.parametrize("kernel,shape,bound_ms", [
    # PERF.md section 6's "bound ms" column at the shapes it shares
    ("k1", "T4800_B4096", 0.0591),
    ("k1csum", "T16720_B4096", 0.1434),
    ("k2", "n2400_B4096", 0.0412),
    ("k3", "L32768_T38", 0.0049),
    ("k3", "L4096_T150", 0.0024),
])
def test_kernel_counts_match_perf_table(kernel, shape, bound_ms):
    s = stats.kernel_table(kernel)["shapes"][shape]
    assert round(1e3 * stats.bound_s(s, stats.peaks()), 4) == bound_ms


def test_unknown_names_are_refused():
    with pytest.raises(harness.RunError):
        harness.find_cell(SPEC, "no.such_cell")
    with pytest.raises(harness.RunError):
        harness.load_json("traffic", "no_such_mix")
    with pytest.raises(harness.RunError):
        harness.load_reader("no_such_metric")
