"""Every configuration, mix, generator and metric of BENCHMARK.json loads
by name, and a new one is found from its files alone."""

import json
import math

import pytest

from benchmark.harness import ROOT, Bench
from benchmark.roofline import chol_solve, match_rows

BENCH = Bench.load()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH.spec["workloads"]])
def test_every_cell_loads_by_name(cell):
    w = BENCH.workload(cell)
    cfg = BENCH.config(w["config"])
    mix = BENCH.traffic(w["traffic"])
    assert cfg["settings"]["Camera"]["Width"] > 0
    assert hasattr(BENCH.driver(mix["driver"]), "run")
    for group in ("end_to_end", "per_layer"):
        assert BENCH.metrics_of(group, cell)


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_every_configuration_file_holds_a_profile_its_world_and_its_guarantees(path):
    cfg = json.loads(path.read_text())
    for key in ("source", "settings", "vocabulary", "world", "stream", "guarantees", "reduced",
                "assumed"):
        assert key in cfg, key
    assert {"Camera", "ORB", "IMU"} <= set(cfg["settings"])
    assert (ROOT / cfg["vocabulary"]["file"]).is_file()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH.spec["per_layer"]])
def test_every_metric_reader_loads_and_reads_nothing_from_an_empty_run(metric):
    reader = BENCH.metric(metric)
    assert reader.read({"kind": "stream", "on_card": True, "trace": None, "shapes": {},
                        "frames": [], "mapper_ms": []}) is None


def test_a_new_config_mix_and_metric_are_found_without_an_edit(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs" / "toy.json").write_text(json.dumps({"settings": {"Camera": {"Width": 8}}}))
    (tmp_path / "traffic" / "toy_mix.json").write_text(json.dumps({"driver": "stream"}))
    (tmp_path / "metrics" / "toy.metric.py").write_text("def read(record):\n    return 7.0\n")
    (tmp_path / "drivers").symlink_to(ROOT / "drivers")
    spec = {"configs": [{"name": "toy", "file": "configs/toy.json"}],
            "workloads": [{"name": "toy.mix", "config": "toy", "traffic": "toy_mix", "chips": 1}],
            "end_to_end": [{"name": "setup_s"}],
            "per_layer": [{"name": "toy.metric", "workloads": ["toy.mix"]}]}
    bench = Bench(spec, root=tmp_path, checkout=tmp_path)
    w = bench.workload("toy.mix")
    assert bench.config(w["config"])["settings"]["Camera"]["Width"] == 8
    assert bench.traffic(w["traffic"])["driver"] == "stream"
    assert hasattr(bench.driver("stream"), "run")
    assert [m["name"] for m in bench.metrics_of("per_layer", "toy.mix")] == ["toy.metric"]
    assert bench.metric("toy.metric").read({}) == 7.0


def test_roofline_counts_of_k2_and_k4():
    # K2 at 1,024 rows x 1,200 columns: the int8 term bounds it
    N, M = 1024, 1200
    ops = 2 * 256 * N * M
    assert math.isclose(match_rows(N, M), ops / 1979e12)
    # K4 at D = 480 (cluster route) and 1,440 (large-D route), one system
    for D, us in ((480, 1.121), (1440, 29.90)):
        assert math.isclose(chol_solve(1, D), (2 * D**3 / 3 + 6 * D * D) / 67e12)
        assert abs(1e6 * chol_solve(1, D) - us) < 0.01  # the port's recorded bounds
