"""The rest of a run on the CPU at a tiny size, the look for a card skipped,
with the timed path broken underneath: `correct` has to come out false for
each fault a serving cell can have (half of a batch left out; an answer
altered where it is produced: a rotation, a Hough centre; every detection
dropped), and true when nothing is broken; and each fault fails the number
meant to catch it."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark.lib import harness
from benchmark.tests.tiny import ROOT, tiny_config

SEED = 5  # a seed whose tiny frames hold detections


def run_cell(workload, tmp_path, seconds=3.0):
    run = harness.make_run(ROOT, workload, SEED, seconds, False, torch.device("cpu"),
                           time.time(), str(tmp_path), config=tiny_config())
    # the CPU serves a few frames a second
    run.traffic.update(warm_frames=2, judge_min_frames=1)
    return harness.execute(run)


def half_batch_left_out(monkeypatch):
    """The second half of every batch is never computed: its label map
    reads background and none of its RoIs is kept."""
    from posecnn_torch.cli import serve

    original = serve.InferenceEngine.infer_device

    def broken(self, data_u8, meta):
        label, rois, poses_init, poses_pred, keep = original(self, data_u8, meta)
        half = (data_u8.shape[0] + 1) // 2
        with torch.inference_mode():
            label = label.clone()
            label[half:] = 0
            keep = keep & (rois[:, 0] < half)
        return label, rois, poses_init, poses_pred, keep

    monkeypatch.setattr(serve.InferenceEngine, "infer_device", broken)


def answer_altered(monkeypatch):
    """Each served rotation is altered where the detections are extracted."""
    from posecnn_torch.cli import serve

    original = serve.extract_detections

    def broken(*args, **kwargs):
        return [(c, np.roll(np.asarray(q), 1), t, *rest)
                for c, q, t, *rest in original(*args, **kwargs)]

    monkeypatch.setattr(serve, "extract_detections", broken)


def detections_dropped(monkeypatch):
    """NMS keeps no row: every frame is served without detections."""
    from posecnn_torch.cli import serve

    original = serve.InferenceEngine.infer_device

    def broken(self, data_u8, meta):
        label, rois, poses_init, poses_pred, keep = original(self, data_u8, meta)
        return label, rois, poses_init, poses_pred, torch.zeros_like(keep)

    monkeypatch.setattr(serve.InferenceEngine, "infer_device", broken)


def centre_moved(monkeypatch):
    """Each Hough centre is moved a third of the frame's width to the right
    where the RoIs are produced (the translations stay as voted)."""
    from posecnn_torch.cli import serve

    original = serve.InferenceEngine.infer_device

    def broken(self, data_u8, meta):
        label, rois, poses_init, poses_pred, keep = original(self, data_u8, meta)
        with torch.inference_mode():
            rois = rois.clone()
            rois[:, 2] += data_u8.shape[2] / 3
            rois[:, 4] += data_u8.shape[2] / 3
        return label, rois, poses_init, poses_pred, keep

    monkeypatch.setattr(serve.InferenceEngine, "infer_device", broken)


def test_a_sound_run_is_correct(tmp_path):
    out = run_cell("serve_b4.posecnn_ycb", tmp_path)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("workload,fault,catcher", [
    ("serve_b4.posecnn_ycb", half_batch_left_out, "label_rel_gap"),
    ("serve_b4.posecnn_ycb", answer_altered, "quat_far_share"),
    ("serve_b1.posecnn_ycb", answer_altered, "quat_far_share"),
    ("serve_b4.posecnn_ycb", detections_dropped, "class_set_diff"),
    ("serve_b1.posecnn_ycb", centre_moved, "centre_off"),
])
def test_a_broken_run_is_not_correct(workload, fault, catcher, tmp_path, monkeypatch):
    fault(monkeypatch)
    out = run_cell(workload, tmp_path)
    assert not out.correct, out.checks
    failing = {k for k, (v, lim) in out.checks.items() if v > lim}
    assert catcher in failing, json.dumps(out.checks)
