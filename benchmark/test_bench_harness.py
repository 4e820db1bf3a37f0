"""The benchmark read as data: BENCHMARK.json against its contract, every
cell, configuration, traffic driver and per-layer reader found by name,
unknown names refused, and a cell, a configuration and a per-layer metric
added by new files alone."""

import json
import re

import pytest

from benchmark import harness, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.Bench(harness.ROOT)


def test_benchmark_json_keeps_its_contract(bench):
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"][1] == "benchmark/run.py"
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) <= 64 * 1024
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (harness.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    names = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in bench.configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        names.add(w["name"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= names
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                   "program_counter", "host_clock")
        for cell in m["workloads"]:  # the cell reports the metric it moves
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
    for cell in names:  # every cell: set-up, another end-to-end metric, a per-layer one
        assert len(bench.metrics_of(cell, False)) >= 2 and bench.metrics_of(cell, True)
        assert "setup_s" in bench.metrics_of(cell, False)


def test_every_piece_is_found_by_its_name(bench):
    for name, entry in bench.cells.items():
        cell = bench.cell(name)
        cfg = bench.config(cell["config"])
        assert cfg["model"]["dit"]["hidden_size"] > 0
        assert bench.driver(cell["driver"]).run
        assert set(cell["limits"]) <= {"wav_gap", "missing", "loss_gap", "grad_gap", "change_gap"}
        for metric in bench.metrics_of(name, True):
            assert callable(bench.reader(metric))


def test_unknown_names_are_refused(bench):
    with pytest.raises(harness.Refused):
        bench.cell("xl-t2a.no-such-mix")
    with pytest.raises(harness.Refused):
        bench.config("no-such-config")
    with pytest.raises(harness.Refused):
        bench.reader("no_such_metric.lat")
    with pytest.raises(harness.Refused):
        bench.driver("no_such_driver")
    with pytest.raises(harness.Refused):
        run.run(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1"],
                root=harness.ROOT, device="cpu")


def test_a_cell_file_must_agree_with_benchmark_json(tiny_root):
    path = tiny_root / "benchmark" / "workloads" / "tiny-t2a.train.json"
    cell = json.loads(path.read_text())
    cell["traffic"] = "another"
    path.write_text(json.dumps(cell))
    with pytest.raises(harness.Refused):
        harness.Bench(tiny_root).cell("tiny-t2a.train")


def test_a_cell_config_and_metric_are_added_by_new_files_alone(tiny_root):
    """A new configuration file, cell file and per-layer reader under the
    checkout, and new entries in BENCHMARK.json: the run reports the new
    metric with no edit to any file of the harness."""
    (tiny_root / "benchmark" / "metrics").mkdir()
    (tiny_root / "benchmark" / "metrics" / "steps_counted.py").write_text(
        "def read(rec):\n    return float(rec['steps'])\n")
    cfg = json.loads((tiny_root / "benchmark" / "configs" / "tiny-t2a.json").read_text())
    cfg["model"]["dit"]["depth"] = 1
    (tiny_root / "benchmark" / "configs" / "tiny-shallow.json").write_text(json.dumps(cfg))
    cell = json.loads((tiny_root / "benchmark" / "workloads" / "tiny-t2a.train.json").read_text())
    cell.update(config="tiny-shallow", traffic="train-short")
    (tiny_root / "benchmark" / "workloads" / "tiny-shallow.train-short.json").write_text(
        json.dumps(cell))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-shallow", "source": "tests",
                            "file": "benchmark/configs/tiny-shallow.json", "reduced": ["depth"],
                            "why": "one block"})
    spec["workloads"].append({"name": "tiny-shallow.train-short", "config": "tiny-shallow",
                              "traffic": "train-short", "chips": 1, "why": "added by files"})
    spec["end_to_end"][3]["workloads"].append("tiny-shallow.train-short")
    spec["per_layer"].append({"name": "steps_counted", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "trainer",
                              "moves": "train_tokens_per_s",
                              "workloads": ["tiny-shallow.train-short"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run.run(["--workload", "tiny-shallow.train-short", "--seed", "2200000001",
                 "--seconds", "0.5", "--trace", "1"], root=tiny_root, device="cpu")
    assert r["correct"] and r["metrics"]["steps_counted"]["value"] == r["attempted"] >= 1
    assert set(r["metrics"]) == {"steps_counted"}
