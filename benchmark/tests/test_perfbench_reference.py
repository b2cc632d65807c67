"""The plain reference against the port on the CPU at a tiny size, the
comparison reading the port as sound, and the fp8 control reading far above
the reference in the configuration's own precision."""

import numpy as np
import pytest
import torch

from benchmark.lib import harness
from benchmark.lib.frames import YCB_K
from benchmark.reference import judge_serve
from benchmark.reference import posecnn as ref
from benchmark.tests.tiny import ROOT, tiny_config

SEED = 5  # a seed whose tiny frames hold detections


@pytest.fixture(scope="module")
def served():
    """Eight frames through the port's serving engine (eager on the CPU) with
    the benchmark's weights, and the reference's serving of the same."""
    import json

    runner = harness.load_module(ROOT / "benchmark" / "runners" / "serve_closed.py", "ref_drv")
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "serve_b1.json").read_text())
    config = tiny_config()
    cell = runner.ServeCell(config, traffic, torch.device("cpu"), SEED)
    frames = cell.frames[:8]
    port = []
    for img in frames:
        canvas = torch.from_numpy(np.ascontiguousarray(img[:, :, ::-1]))[None]
        meta = torch.from_numpy(cell.engine._meta0)
        label = cell.engine.infer_device(canvas, meta)[0][0].clone()
        port.append((img, label, cell.engine.infer_batch([img], [YCB_K])[0]["detections"]))
    weights = ref.make_weights(ref.param_specs(config), SEED, "cpu")
    extents = torch.from_numpy(cell.extents_np)
    mine = ref.serve_frames(weights, frames, extents, YCB_K, config, "fp32")
    return config, weights, extents, port, mine


def test_reference_forward_agrees_with_the_port(served):
    config, _, _, port, mine = served
    n_dets = 0
    for (_, label, dets), (my_label, my_dets) in zip(port, mine):
        assert (label == my_label).float().mean() > 0.999
        assert [d["class"] for d in dets] == [d["class"] for d in my_dets]
        for d, m in zip(dets, my_dets):
            n_dets += 1
            np.testing.assert_allclose(d["roi"], m["roi"], atol=1e-3)
            np.testing.assert_allclose(d["score"], m["score"], rtol=1e-5)
            np.testing.assert_allclose(d["trans"], m["trans"], rtol=1e-3, atol=1e-6)
            np.testing.assert_allclose(d["quat_wxyz"], m["quat_wxyz"], atol=1e-4)
    assert n_dets > 0


def test_the_comparison_reads_the_port_as_sound(served):
    config, weights, extents, port, _ = served
    nums = judge_serve.judge(weights, config, extents, YCB_K, port)
    assert max(nums.values()) < 1e-3, nums


def test_the_fp8_control_reads_far_above_the_bf16_witness(served):
    """The control: the reference in the program's place at float8, against
    the reference at the configuration's bfloat16, judged alike."""
    config, weights, extents, port, _ = served
    frames = [p[0] for p in port]
    reads = {}
    for precision in ("bf16", "fp8"):
        out = ref.serve_frames(weights, frames, extents, YCB_K, config, precision)
        reads[precision] = judge_serve.judge(weights, config, extents, YCB_K,
                                             [(f, lab, d) for f, (lab, d) in zip(frames, out)])
    for name in ("label_rel_gap", "quat_far_share", "trans_far_share"):
        assert reads["fp8"][name] > 3 * reads["bf16"][name], reads
