"""The harness: finds a cell's pieces by name, runs its runner, checks the
run, reads the metrics and prints the result line.

Everything that belongs to one configuration, traffic mix, runner or
per-layer metric is a file of its own, found by the name `BENCHMARK.json`
gives it:

  benchmark/configs/<config>.json     the configuration (`file` in BENCHMARK.json)
  benchmark/traffic/<traffic>.json    the mix: parameters and the runner's name
  benchmark/runners/<runner>.py       `run(run) -> Outcome`
  benchmark/metrics/<metric>.py       `read(run, outcome) -> float | None`
  benchmark/limits/<config>.<judge>.json  the limit of each number compared
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

# top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "posecnn_tpu")


@dataclass
class Run:
    """What a runner and a metric reader are given."""

    root: Path
    bench: dict
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_process: float
    tmpdir: str

    def limits(self, judge: str) -> dict:
        """The limits of a judge's numbers for this cell's configuration."""
        path = self.root / "benchmark" / "limits" / f"{self.cell['config']}.{judge}.json"
        return json.loads(path.read_text())["limits"]


@dataclass
class Outcome:
    """What a runner returns."""

    attempted: int
    failed: int
    end_to_end: dict  # metric name -> value
    checks: dict  # number name -> (value, limit)
    memory_peak_bytes: int
    observed: dict = field(default_factory=dict)  # raw data for the per-layer readers
    trace: object = None  # a trace.TraceSummary of the profiled sub-window

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark: {path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"benchmark: no workload {workload!r} in BENCHMARK.json; "
                   f"have {[c['name'] for c in bench['workloads']]}")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"benchmark: no configuration {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: dict) -> bool:
    """Whether a metric belongs in this cell's line: listed for it, or listed
    for no cell in particular."""
    return cell["name"] in metric.get("workloads", [cell["name"]])


def end_to_end_for(bench: dict, cell: dict) -> list:
    return [m for m in bench["end_to_end"] if applies(m, cell)]


def per_layer_for(bench: dict, cell: dict) -> list:
    return [m for m in bench["per_layer"] if applies(m, cell)]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"  # no library loads JAX behind the program's back


def make_run(root: Path, workload: str, seed: int, seconds: float, trace: bool, device,
             t_process: float, tmpdir: str, bench: dict | None = None,
             config: dict | None = None) -> Run:
    """A Run from BENCHMARK.json (or the `bench` and `config` given)."""
    bench = bench if bench is not None else json.loads((root / "BENCHMARK.json").read_text())
    cell = find_cell(bench, workload)
    if config is None:
        config = json.loads((root / config_entry(bench, cell["config"])["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    return Run(root, bench, cell, config, traffic, seed, seconds, trace, device, t_process,
               tmpdir)


def execute(run: Run) -> Outcome:
    runner = load_module(run.root / "benchmark" / "runners" / f"{run.traffic['runner']}.py",
                         f"benchmark_runner_{run.traffic['runner']}")
    return runner.run(run)


def result_line(run: Run, outcome: Outcome, device_info: dict) -> dict:
    """The contract's last line; `checks` is its last key."""
    metrics = {}
    if run.trace:
        for m in per_layer_for(run.bench, run.cell):
            reader = load_module(run.root / "benchmark" / "metrics" / f"{m['name']}.py",
                                 "benchmark_metric_" + m["name"].replace(".", "_"))
            value = reader.read(run, outcome)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in end_to_end_for(run.bench, run.cell):
            if m["name"] not in outcome.end_to_end:
                raise KeyError(f"benchmark: the runner did not measure {m['name']!r}")
            metrics[m["name"]] = {"value": float(outcome.end_to_end[m["name"]]),
                                  "unit": m["unit"]}
    line = {"correct": outcome.correct, "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics, "device": device_info}
    if run.trace and outcome.trace is not None:
        device_info["busy_s"] = outcome.trace.busy_s
        device_info["window_s"] = outcome.trace.window_s
        line["breakdown"] = {"device_ops": outcome.trace.top_ops(),
                             "idle_gaps": outcome.trace.top_idle()}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return line


def main(argv, root: str, t_process: float) -> int:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path(root)
    cache_dirs(root)
    t0 = time.time()
    import torch

    t_torch = time.time()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    chips = find_cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.cuda.init()
    print(f"setup: interpreter {t0 - t_process:.3f} s, import torch {t_torch - t0:.3f} s, "
          f"CUDA {time.time() - t_torch:.3f} s", file=sys.stderr)
    with tempfile.TemporaryDirectory() as tmpdir:
        run = make_run(root, args.workload, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda:0"), t_process, tmpdir, bench=bench)
        outcome = execute(run)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = result_line(run, outcome, device_info)
    bad = [k for k, v in line["metrics"].items() if not math.isfinite(v["value"])]
    if bad:
        print(f"benchmark: metrics {bad} are not finite; no result", file=sys.stderr)
        return 5
    for name, (value, limit) in outcome.checks.items():
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

