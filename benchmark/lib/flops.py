"""The model's floating-point operations, counted once from the plain
reference under `torch.utils.flop_counter.FlopCounterMode`, on meta tensors
at a cell's shapes (no memory, no device).

    python3 benchmark/lib/flops.py benchmark/configs/posecnn_ycb.json

prints the numbers that the configuration file stores (`flops_per_frame`);
a test holds the file to them. They count the model's work (its
convolutions and dense layers) whatever implements it: not the program's
padding, its dense RoI-pooling products, nor Hough's elementwise votes.
"""

from __future__ import annotations

import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode


def serve_flops_per_frame(config: dict) -> int:
    """One frame's forward: the trunk and both heads at the frame's size, and
    the pose head's fc6-fc8 over the `max_objects` RoI rows the serving
    forward computes a frame."""
    from benchmark.reference import posecnn as ref

    meta = torch.device("meta")
    weights = {name: torch.empty(shape, device=meta) for name, shape, _ in ref.param_specs(config)}
    x = torch.empty((1, 3, config["height"], config["width"]), device=meta)
    rows = config["max_objects"]
    pooled = torch.empty((rows, config["pose_pool_size"] ** 2 * 512), device=meta)
    with FlopCounterMode(display=False) as counter:
        c4, c5 = ref.trunk(weights, x, "fp32")
        ref.skip_head(weights, "seg_head.score", c4, c5, "fp32", relu=True)
        ref.skip_head(weights, "vertex_head.vertex", c4, c5, "fp32", relu=False)
        h = ref.linear(pooled, weights["pose_head.fc6.weight"], weights["pose_head.fc6.bias"], "fp32")
        h = ref.linear(h, weights["pose_head.fc7.weight"], weights["pose_head.fc7.bias"], "fp32")
        ref.linear(h, weights["pose_head.fc8.weight"], weights["pose_head.fc8.bias"], "fp32")
    return int(counter.get_total_flops())


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    cfg = json.load(open(sys.argv[1]))
    print(json.dumps({"flops_per_frame": serve_flops_per_frame(cfg)}))
