"""The benchmark's harness on the CPU: every piece found by name, the
contract's shape, the generators repeating per seed, the FLOP counts, the
result line, and no JAX loaded."""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.lib import harness
from benchmark.lib.flops import serve_flops_per_frame
from benchmark.lib.frames import class_extents, planted_frames
from benchmark.reference import posecnn as ref
from benchmark.tests.tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert os.path.getsize(ROOT / "BENCHMARK.json") <= 64 * 1024


def test_every_cell_finds_its_pieces():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for cell in BENCH["workloads"]:
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        entry = harness.config_entry(BENCH, cell["config"])
        assert entry["file"].startswith("benchmark/")
        config = json.loads((ROOT / entry["file"]).read_text())
        assert config["name"] == cell["config"] and config["reduced"] == entry["reduced"]
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json")
                             .read_text())
        runner = ROOT / "benchmark" / "runners" / f"{traffic['runner']}.py"
        assert runner.is_file()
        reported = [m["name"] for m in harness.end_to_end_for(BENCH, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        layers = harness.per_layer_for(BENCH, cell)
        assert layers, cell["name"]
        for m in layers:
            assert m["moves"] in reported and m["moves"] in e2e
            reader = harness.load_module(ROOT / "benchmark" / "metrics" / f"{m['name']}.py",
                                         "t_" + m["name"].replace(".", "_"))
            assert callable(reader.read)
    for m in BENCH["per_layer"]:
        cells = {c["name"] for c in BENCH["workloads"]}
        assert set(m.get("workloads", cells)) <= cells


def test_limits_cover_every_number():
    from benchmark.reference import judge_serve

    limits = json.loads((ROOT / "benchmark" / "limits" / "posecnn_ycb.serve.json").read_text())
    assert set(limits["limits"]) == set(judge_serve.NUMBERS)


def test_result_line_has_the_contract_keys():
    run = harness.make_run(ROOT, BENCH["workloads"][0]["name"], 5, 1.0, False,
                           torch.device("cpu"), 0.0, "")
    out = harness.Outcome(attempted=10, failed=0,
                          end_to_end={"setup_s": 1.0, "frames_per_s": 2.0, "frame_p95_ms": 3.0},
                          checks={"label_gap": (0.1, 0.2)}, memory_peak_bytes=7)
    line = harness.result_line(run, out, {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                                          "count": 1, "memory_peak_bytes": 7})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert line["device"]["kind"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in harness.end_to_end_for(BENCH, run.cell)}
    assert {"setup_s", "frame_p95_ms"} <= set(line["metrics"])
    out.checks["label_gap"] = (0.3, 0.2)
    assert harness.result_line(run, out, {})["correct"] is False


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 77])
def test_frames_repeat_per_seed(seed):
    ext = class_extents(seed, 22, 0.05, 0.25)
    a, pa = planted_frames(seed, 3, 96, 128, 22, ext)
    b, pb = planted_frames(seed, 3, 96, 128, 22, class_extents(seed, 22, 0.05, 0.25))
    c, _ = planted_frames(seed + 1, 3, 96, 128, 22, ext)
    assert all(np.array_equal(x, y) for x, y in zip(a, b)) and pa == pb
    assert not np.array_equal(a[0], c[0])
    assert all(3 <= len(p) <= 8 and len({o[0] for o in p}) == len(p) for p in pa)
    assert ext[0].tolist() == [0, 0, 0] and (ext[1:] >= 0.05).all() and (ext[1:] <= 0.25).all()


def test_weights_repeat_per_seed():
    from benchmark.tests.tiny import tiny_config

    specs = ref.param_specs(tiny_config())
    a = ref.make_weights(specs, 2 ** 31 + 5, "cpu")
    b = ref.make_weights(specs, 2 ** 31 + 5, "cpu")
    c = ref.make_weights(specs, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["trunk.conv3_1.weight"], c["trunk.conv3_1.weight"])
    w = a["trunk.conv3_1.weight"]
    assert abs(float(w.std()) - (2.0 / w[0].numel()) ** 0.5) < 0.05 * (2.0 / w[0].numel()) ** 0.5


def test_flops_match_the_configuration_files():
    for entry in BENCH["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        assert config["flops_per_frame"] == serve_flops_per_frame(config)


def test_no_jax_in_what_a_cell_loads():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.lib import harness\n"
        "import benchmark.calibrate, benchmark.lib.flops, benchmark.lib.trace\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "for cell in bench['workloads']:\n"
        "    t = json.load(open(f\"benchmark/traffic/{cell['traffic']}.json\"))\n"
        "    harness.load_module(harness.Path(f\"benchmark/runners/{t['runner']}.py\"), 'd')\n"
        "import posecnn_torch.cli.serve, posecnn_torch.engine.evaluate\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_result_without_a_card(tmp_path):
    """On the CPU the command exits non-zero and prints no result; so it does
    from a directory that holds only the benchmark's files."""
    cell = BENCH["workloads"][0]["name"]
    args = [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "3",
            "--seconds", "1", "--trace", "0"]
    out = subprocess.run(args, cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(args, cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_reservoir_keeps_the_judged_calls_few():
    """The sample of engine calls the comparison reads stays at judge_calls."""
    runner = harness.load_module(ROOT / "benchmark" / "runners" / "serve_closed.py", "t_drv")
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "serve_b4.json").read_text())
    cell = runner.ServeCell.__new__(runner.ServeCell)
    cell.traffic, cell.sampling, cell.samples, cell.calls = traffic, True, [], 0
    cell.reservoir_rng = np.random.default_rng(1)
    cell._infer_device = lambda d, m: (d,)
    for i in range(500):
        cell._sampled_infer_device(torch.tensor([i]), None)
    assert len(cell.samples) == traffic["judge_calls"] and cell.calls == 500
