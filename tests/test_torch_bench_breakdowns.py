"""The breakdown benches of `posecnn_torch/bench.py` on the CPU: `c2f`,
`components`, `hough`, `train_components`, `train_mfu` and `profile`.

Each one's configuration against its JAX script (`experiments/`): names,
switches, sizes, loop counts, cfg keys and points, read from the script's
source or held to its literal values; the derived differences of
`train_components` on a fake clock; one tiny training step of each
`train_components` variant; a `train_mfu` point and `profile` at a tiny
size with the card's clocks stubbed, and what they write; the planted
samples the c2f and Hough benches vote on; and the exit without a card.
The benches time CUDA graphs and CUDA events, so they run only on a card
(`chip_smoke.py` phase 17).
"""

import ast
import os
import re

import numpy as np
import pytest
import torch

from posecnn_torch import bench

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_classes=4, fc_dim=32, num_units=8, hough_num_samples=32,
            compute_dtype=torch.float32)
NEW_COMMANDS = ["c2f", "components", "hough", "train_components", "train_mfu", "profile"]


def script(name: str) -> str:
    with open(os.path.join(REPO, "experiments", name)) as f:
        return f.read()


def timed_defaults(source: str) -> tuple:
    """(n1, n2) of a script's `def timed(fn, args, n1=…, n2=…)`."""
    n1, n2 = re.search(r"def timed\(fn, args, n1=(\d+), n2=(\d+)\)", source).groups()
    return int(n1), int(n2)


@pytest.mark.parametrize("command", NEW_COMMANDS)
def test_each_command_without_a_card_exits_nonzero(command, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([command]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_c2f_and_hough_configuration_is_the_scripts():
    for name, n in (("bench_graph_phases.py", bench.C2F_N),
                    ("bench_components.py", bench.COMPONENTS_N),
                    ("bench_hough_phases.py", bench.HOUGH_N)):
        assert timed_defaults(script(name)) == n, name
    graph = script("bench_graph_phases.py")
    tunings = re.findall(r'\("(c2f_\w+)", dict\(coarse_factor=(\d+), top_t=(\d+)\)\)', graph)
    assert [(n, str(kw["coarse_factor"]), str(kw["top_t"])) for n, kw in bench.C2F_TUNINGS] \
        == tunings
    for source in (graph, script("bench_hough_phases.py")):
        planted = re.search(r"for cls, cx, cy, r in (\[.*?\]):", source).group(1)
        assert tuple(ast.literal_eval(planted)) == bench.PLANTED_LABEL
        prep = re.search(r"num_classes=c, (label_threshold=.*?max_classes=\d+)", source,
                         re.S).group(1)
        assert dict(re.findall(r"(\w+)=(\d+)", prep)) == {
            k: str(v) for k, v in bench.PREP_KW.items()}
    assert bench.C2F_OUT != os.path.join("output", "bench_graph_phases.json")


def test_components_configuration_is_the_scripts():
    source = script("bench_components.py")
    models = re.findall(r'\("(\w+)", dict\(vertex_reg=(\w+), pose_reg=(\w+)\)\)', source)
    assert [(n, str(kw["vertex_reg"]), str(kw["pose_reg"])) for n, kw in bench.COMPONENT_MODELS] \
        == models
    reported = re.findall(r'report\("(\w+)"', source) + [m[0] for m in models]
    assert set(reported) == {"trunk", "seg_only", "seg_vertex_hough", "full", "hough_alone",
                             "roi_posehead_alone"}
    assert "np.zeros(8), np.arange(1, 9)" in source and bench.COMPONENT_ROIS == 8


def test_train_variants_are_the_scripts():
    """bench_train_components.py:147-161, each variant's changes to the
    step, and its loop counts."""
    assert [n for n, _ in bench.TRAIN_VARIANTS] == re.findall(
        r'out\["(\w+)"\] = measure\(', script("bench_train_components.py"))
    assert dict(bench.TRAIN_VARIANTS) == {
        "full": {}, "rows_126": {"max_objects": 7},
        "rows_126_compact64": {"max_objects": 7, "max_pose_rois": 64},
        "no_pose": {"pose_reg": False}, "seg_only": {"vertex_reg": False, "pose_reg": False},
        "add_p128": {"n_points": 128}, "fc1024": {"fc_dim": 1024},
        "res_240x320": {"height": 240, "width": 320, "focal_scale": 0.5},
        "batch1": {"batch": 1}}
    assert "n1, n2 = 3, 23" in script("bench_train_components.py")
    assert bench.TRAIN_COMPONENTS_N == (3, 23)
    assert bench.SEG_ONLY_KEYS == ("data", "label", "meta", "gt_poses", "gt_valid")


def test_train_differences_on_a_fake_clock(monkeypatch):
    """Every timed run of a variant costs a fixed 5 s plus its per-step ms
    on the fake clock (a quarter of it for the compiled step): the bench
    reports each variant's per-step ms and the script's six differences of
    them, eager and compiled."""
    per_step = {"full": 100.0, "rows_126": 120.0, "rows_126_compact64": 110.0,
                "no_pose": 70.0, "seg_only": 40.0, "add_p128": 95.0, "fc1024": 90.0,
                "res_240x320": 31.0, "batch1": 60.0}
    variants = {tuple(sorted(kw.items())): name for name, kw in bench.TRAIN_VARIANTS}
    current = {}

    def fake_setup(device, **kw):
        current["ms"] = per_step[variants[tuple(sorted(kw.items()))]]
        return None, None, {"data": torch.zeros(1)}

    def fake_timed(fn, device):
        fn()
        return (5.0 + current["n"] * current["ms"] * current["scale"] / 1e3,) * 2

    monkeypatch.setattr(bench, "card_line", lambda: {"device": "fake", "power_limit": "0 W"})
    monkeypatch.setattr(bench, "train_setup", fake_setup)
    monkeypatch.setattr(bench, "train_steps", lambda s, st, b, n: current.update(n=n, scale=1))
    monkeypatch.setattr(bench, "compiled_twin", lambda step: None)
    monkeypatch.setattr(bench, "compiled_steps",
                        lambda s, st, b, n: current.update(n=n, scale=0.25))
    monkeypatch.setattr(bench, "compiled_launches",
                        lambda step: {"tile": 0, "flat": 1, "window": 1})
    monkeypatch.setattr(bench, "snapshot", lambda step, state: lambda: None)
    monkeypatch.setattr(bench, "timed", fake_timed)
    # the profiled step's device is busy half the step
    monkeypatch.setattr(bench, "step_busy_ms", lambda s, st, b: (current["ms"] / 2, 1.0))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    lines = bench.bench_train_components("cpu")
    assert [line["variant"] for line in lines[:-1]] == list(per_step)
    for line in lines[:-1]:
        assert line["ms_per_iter"] == pytest.approx(per_step[line["variant"]])
        assert line["compiled_ms_per_iter"] == pytest.approx(per_step[line["variant"]] / 4)
        assert line["profiled_step_device_busy_ms"] == per_step[line["variant"]] / 2
    summary = lines[-1]
    assert summary["metric"] == "posecnn_torch_train_components_480x640_b2_h100"
    want = {"pose_branch_ms": 30.0, "vertex_branch_ms": 30.0, "add_points_ms": 5.0,
            "fc_width_ms": 10.0, "fixed_cost_est_ms": 8.0, "compaction_saves_ms": 10.0}
    for key, value in want.items():
        assert summary[key] == pytest.approx(value), key
        assert summary["device_busy_differences"][key] == pytest.approx(value / 2), key
        assert summary["compiled_differences"][key] == pytest.approx(value / 4), key


def tiny_variant(variant: dict) -> dict:
    """A variant at a size the CPU runs in a second: a tenth of its frame,
    fc1024's fc6/fc7 a quarter of the others' as 1024 is of 4096."""
    kw = {**TINY, **variant, "height": variant.get("height", 480) // 10,
          "width": variant.get("width", 640) // 10}
    if "fc_dim" in variant:
        kw["fc_dim"] = TINY["fc_dim"] // 4
    return kw


@pytest.mark.parametrize("name", [n for n, _ in bench.TRAIN_VARIANTS])
def test_each_train_variant_takes_a_tiny_step(name):
    variant = dict(bench.TRAIN_VARIANTS)[name]
    step, state, batch = bench.train_setup("cpu", **tiny_variant(variant))
    t, model = step.cfg.train, step.model
    assert t.vertex_reg_2d == variant.get("vertex_reg", True)
    assert t.pose_reg == variant.get("pose_reg", True)
    assert t.ims_per_batch == variant.get("batch", 2) == batch["data"].shape[0]
    assert t.add_num_points == variant.get("n_points", 512) == step.points.shape[1]
    assert (model.hough_kw["max_objects_per_image"], model.max_pose_rois) == (
        variant.get("max_objects", 2), variant.get("max_pose_rois", 0))
    assert (model.vertex_head is None, model.pose_head is None) == (
        not variant.get("vertex_reg", True), not variant.get("pose_reg", True))
    if not variant.get("vertex_reg", True):
        assert tuple(batch) == bench.SEG_ONLY_KEYS
    # the focal length scales with the frame (bench_train_components.py:69-75)
    fx = batch["meta"][0, 0].item()
    assert fx == pytest.approx(1066.778 * variant.get("focal_scale", 1.0), rel=1e-6)
    loss = bench.train_steps(step, state, batch, 1)
    assert torch.isfinite(loss) and state.step == 1


def test_mfu_points_and_cfg_are_the_scripts():
    source = script("bench_train_mfu.py")
    points = re.search(r"for b, scale in (\[.*?\]):", source).group(1)
    assert tuple(ast.literal_eval(points)) == bench.MFU_POINTS
    assert "n1, n2 = 3, 13" in source and bench.MFU_N == (3, 13)
    for b, scale in bench.MFU_POINTS:
        setup = bench.mfu_setup(b, scale)
        assert (setup["height"], setup["width"]) == (int(480 * scale), int(640 * scale))
        assert setup["focal_scale"] == scale and setup["max_gt"] == 8 * b
        assert setup["max_objects"] == 1 and setup["gt_pose_rois"]
        assert setup["train"] == {"max_rois": 16 * b, "gt_pose_rois": True, "optimizer": "adam",
                                  "grad_clip": 35.0}
    assert bench.PEAK_BF16_TFLOPS == 989.0
    assert bench.MFU_OUT != os.path.join("output", "bench_train_mfu.json")


def test_profile_configuration(monkeypatch, tmp_path):
    source = script("profile_train.py")
    assert "for i in range(20):" in source and "for i in range(5):" in source
    assert "[:40]" in source
    assert (bench.PROFILE_HOST_SYNC_STEPS, bench.PROFILE_TRACED_STEPS, bench.PROFILE_TOP) == (
        20, 5, 40)
    monkeypatch.setenv("POSECNN_TRACE_DIR", str(tmp_path))
    assert bench.trace_dir() == str(tmp_path)
    monkeypatch.delenv("POSECNN_TRACE_DIR")
    assert bench.trace_dir().endswith("posecnn_torch_trace")
    assert bench.PROFILE_OUT != os.path.join("output", "train_profile.json")


def test_planted_slots_and_c2f_body():
    """The c2f and Hough benches' samples at 480×640: the three planted
    classes fill 3 of the 8 slots, and the c2f body votes in those 3."""
    label, vert, extents, meta, packed, bboxes = bench.planted_slots("cpu")
    assert packed.shape == (8, 8, 128) and bboxes.shape == (8, 4)
    assert label.shape == (1, 480, 640) and vert.shape == (1, 480, 640, 66)
    np.testing.assert_array_equal(torch.unique(label).numpy(), [0, 3, 9, 15])
    live = packed[:, 7].amax(1) > 0
    assert live.tolist() == [True] * 3 + [False] * 5
    out = bench.c2f_body(packed, bboxes, coarse_factor=8, top_t=2)
    assert all(o.shape == (8,) for o in out)
    assert bool((out[0][:3] > 0).all()) and bool((out[0][3:] == 0).all())
    assert torch.isfinite(bench.c2f_sum(out))


@pytest.fixture
def tiny_card(monkeypatch, tmp_path):
    """`train_mfu` and `profile` on the CPU: a tiny step, CUDA events and
    memory counters stubbed, the outputs under a temporary directory."""
    setup, built = bench.train_setup, []

    def tiny_setup(device, **kw):
        built.append(setup(device, **{**kw, **TINY, "height": 48, "width": 64}))
        return built[-1]

    monkeypatch.setattr(bench, "train_setup", tiny_setup)
    monkeypatch.setattr(bench, "card_line", lambda: {"device": "fake", "power_limit": "0 W"})
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 1)
    monkeypatch.setenv("POSECNN_TRACE_DIR", str(tmp_path / "trace"))
    monkeypatch.chdir(tmp_path)
    return tmp_path, built


def test_train_mfu_takes_a_tiny_step_and_writes_the_scripts_rows(tiny_card, monkeypatch):
    """One point at a tiny size: its cfg and batch are the script's, the
    warm-up step and the counted one train, and each row carries the JAX
    row's keys (`compile_s` is the warm-up's `warmup_s`, the device-only
    `device_s_per_iter` the eager step's `s_per_iter_eager`) and the MFU of
    the step's device-busy time."""
    import json

    tmp, built = tiny_card
    monkeypatch.setattr(bench, "MFU_POINTS", ((2, 0.1),))
    monkeypatch.setattr(bench, "train_seconds", lambda *a: (0.25, 0.25))
    monkeypatch.setattr(bench, "step_busy_ms", lambda *a: (125.0, 250.0))
    lines = bench.bench_train_mfu("cpu")
    (step, state, batch), = built
    t = step.cfg.train
    assert (t.optimizer, t.grad_clip, t.gt_pose_rois, t.max_rois) == ("adam", 35.0, True, 32)
    assert step.model.gt_pose_rois and batch["gt_poses"].shape[0] == 16
    assert isinstance(state.opt.opt, torch.optim.Adam) and state.step == 2
    assert all(torch.isfinite(p).all() for p in step.model.parameters())
    row = re.search(r"row = \{(.*?)\n        \}", script("bench_train_mfu.py"), re.S).group(1)
    renamed = {"compile_s": "warmup_s", "device_s_per_iter": "s_per_iter_eager"}
    want = {renamed.get(key, key) for key in re.findall(r'"(\w+)":', row)}
    assert want <= set(lines[0]) and lines[0]["step_flops"] > 0
    assert lines[0]["samples_per_s"] == 8.0 and lines[0]["hw"] == [48, 64]
    assert lines[0]["step_busy_ms"] == 125.0
    assert lines[0]["mfu_pct_busy"] == pytest.approx(2 * lines[0]["mfu_pct"])
    with open(tmp / bench.MFU_OUT) as f:
        assert json.load(f)["points"] == lines[:-1]


def test_profile_writes_the_scripts_summary(tiny_card, monkeypatch):
    import json

    monkeypatch.setattr(bench, "PROFILE_HOST_SYNC_STEPS", 1)
    monkeypatch.setattr(bench, "PROFILE_TRACED_STEPS", 1)
    monkeypatch.setattr(bench, "step_flops", lambda *a: 1e9)
    mfu_line, plane, summary = bench.bench_profile("cpu")
    assert set(mfu_line) >= {"metric", "step_flops", "s_per_iter_host_sync", "achieved_tflops",
                             "peak_tflops_assumed", "mfu"}
    assert plane["plane"] == "/device:GPU:0 (fake)" and summary["planes"] == [plane["plane"]]
    assert os.path.exists(summary["trace"])
    with open(tiny_card[0] / bench.PROFILE_OUT) as f:
        written = json.load(f)
    assert written["mfu"] == mfu_line and list(written["per_plane"]) == summary["planes"]
