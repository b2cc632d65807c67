"""A configuration at a size a CPU test run holds: the published widths of
the trunk and the vertex head, the frame, the classes, the pose head's width
and Hough's samples cut down."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_config(name="posecnn_ycb", **overrides):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    cfg.update(num_classes=4, height=64, width=96, num_units=8, fc_dim=32, hough_num_samples=64)
    cfg.update(overrides)
    return cfg
