"""The benchmark's driver: finds a cell's configuration, traffic mix,
generator and per-layer metrics by the names in `BENCHMARK.json`, runs the
generator, and prints the contract's last line.

Layout (a later cell, configuration, mix or metric is new files and new
entries, never an edit):
- `configs/<config>.json`: a deployment (the settings profile as it
  stands, the vocabulary, the world and trajectory, its guarantees);
- `traffic/<mix>.json`: a mix's parameters; its `driver` names the
  generator `drivers/<driver>.py` that reads it;
- `metrics/<metric>.py`: a per-layer metric's reader, `read(record)`,
  which returns None where the run holds nothing for it to read.

Exit codes: 0 with the result line; 2 without the CUDA devices the cell
asks for; 3 when JAX or the JAX package is loaded after the window; 1 on
any other failure. No line is printed but on 0.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "monoorbslam3_tpu"}


def _import_file(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """`BENCHMARK.json` and the files it names, found under `root` (the
    benchmark's folder) and `checkout` (where the configurations' `file`
    paths start)."""

    def __init__(self, spec: dict, root: Path = ROOT, checkout: Path = CHECKOUT):
        self.spec, self.root, self.checkout = spec, Path(root), Path(checkout)

    @staticmethod
    def load(path: Path = CHECKOUT / "BENCHMARK.json", root: Path = ROOT) -> "Bench":
        with open(path) as f:
            return Bench(json.load(f), root, Path(path).parent)

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(self.checkout / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.root / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def driver(self, name: str):
        return _import_file(self.root / "drivers" / f"{name}.py", f"_bench_driver_{name}")

    def metric(self, name: str):
        return _import_file(self.root / "metrics" / f"{name}.py", f"_bench_metric_{name}")

    def metrics_of(self, group: str, workload: str) -> list[dict]:
        """The metrics of `end_to_end` or `per_layer` a cell reports: those
        that list it, and those that list no cells."""
        return [m for m in self.spec[group] if workload in m.get("workloads", [workload])]


class Job:
    """What a generator gets: the cell's configuration and mix, the run's
    arguments, and where to log (standard error)."""

    def __init__(self, bench, workload, cfg, mix, seed, seconds, trace, device, control):
        self.bench, self.workload, self.cfg, self.mix = bench, workload, cfg, mix
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.control = device, control
        self.root = bench.root

    @staticmethod
    def log(*parts):
        print(*parts, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu: a CPU rehearsal, whose "
                         "times and rates read 'not measured'")
    ap.add_argument("--control", action="store_true",
                    help="judge the reference in TF32 in the port's place (the control "
                         "each limit was set against); the result line reads it, and "
                         "standard error the port's own readings before it")
    return ap.parse_args(argv)


def loaded_forbidden() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv, t_start, bench: Bench | None = None) -> int:
    args = parse(argv)
    import torch

    bench = bench or Bench.load()
    w = bench.workload(args.workload)
    on_card = args.device != "cpu"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]):
        print(f"benchmark: the cell asks for {w['chips']} CUDA device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cfg = bench.config(w["config"])
    mix = bench.traffic(w["traffic"])
    job = Job(bench, w, cfg, mix, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0) if on_card else torch.device("cpu"), args.control)
    driver = bench.driver(mix["driver"])
    out = driver.run(job, t_start)

    if args.trace:
        metrics = {}
        for m in bench.metrics_of("per_layer", w["name"]):
            value = bench.metric(m["name"]).read(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in bench.metrics_of("end_to_end", w["name"])}
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: JAX or the JAX package is loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    checks = out["checks"]
    correct = all(v["value"] is not None and v["value"] <= v["limit"] for v in checks.values())
    for name, v in checks.items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace and out.get("trace"):
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if args.trace and out.get("trace"):
        line["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                             "idle_gaps": out["trace"]["idle_gaps"]}
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


def check(value, limit) -> dict:
    return {"value": value, "limit": limit}
