"""The comparison that decides `correct` for a served PoseCNN frame.

The program's outputs are judged against the fp32 reference
(`reference/posecnn.py`), computed anew from the frame and the weights the
benchmark made. The label map is judged by the reference's own scores; the
Hough stage follows the program's label map (one changed pixel moves every
later sample, so the reference takes the samples where the program took
them) and is judged at the centre the program chose; the pose head is
judged at the RoI the program served. The numbers:

  label_rel_gap    the widest, over the judged frames' pixels, of the gap by
                   which the reference's score of the served label lies below
                   its best score, over that pixel's spread of scores (best
                   less least)
  quat_far_share   the share of served detections whose unit quaternion lies
                   farther than QUAT_TOL from the reference's at the served RoI
  trans_far_share  the share of served detections whose translation lies
                   farther than TRANS_TOL, relative, from the reference's at the
                   served centre (the mean depth of its inlier samples along
                   the centre's ray); a served class with no samples in the
                   program's own label map, or no votes at its centre, is far

and, exact (limit 0, in EXACT):

  class_set_diff   the classes that the program's label map presents (more
                   than `label_threshold` pixels, the first `max_classes`)
                   and whose reference maximum gathers MIN_SHARE of the
                   class's samples as inliers or more, but that are not
                   served (a detection left out by Hough, NMS or
                   extraction); and the served classes that the label map
                   does not present. A class whose maximum holds a few
                   samples (a degenerate vertex field: depths of kilometres
                   shrink the vote gate to a pixel) may be served or not:
                   its box can be a point, and one sample more or less
                   moves its centre.
  centre_off       served detections of such classes whose centre the
                   reference's votes put below CENTRE_TOL of the reference's
                   own maximum over the class's coarse-to-fine candidate
                   cells (the Hough centre)

The tolerances lie above what the configuration's own bf16 rounding gives
nine detections in ten (quaternions 0.01-0.02, translations 0.02-0.04) and
below what float8 gives most. Readings that did not separate the program
from the control are not compared as such: the label gap over the frame's
score spread, the widest, mean, median or 90th-percentile quaternion and
translation errors, the widest gap of the reference's votes at a served
centre below its own maximum or the served score, the box (the farthest
inlier sample), and the valid classes of the reference's own label map. A
centre is an argmax over near-tied cells, a box the farthest of its
inliers, a translation the mean of a few inliers' heavy-tailed depths, a
quaternion the direction of a vector that can be short, and a label's gap
scales with its pixel's scores, so rounding in the configuration's own
precision moves a few of them as far as the control moves many (PERF.md
gives the readings). The two exact counts hold the Hough, NMS and
extraction stages to what no rounding of either precision reaches: a
sound centre's votes lie within a quarter of the maximum, and a class
that the served label map presents is served (PERF.md gives the readings).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import posecnn as ref

NUMBERS = ("label_rel_gap", "quat_far_share", "trans_far_share")
EXACT = ("class_set_diff", "centre_off")
QUAT_TOL = 0.05  # unit-quaternion distance, about 5.7 degrees
TRANS_TOL = 0.05  # relative distance
CENTRE_TOL = 0.5  # a centre's reference votes against the reference's maximum
MIN_SHARE = 1 / 64  # of a class's samples, inliers at its maximum that make it due


def far_share(values, tol) -> float:
    """The share of `values` over `tol` (an infinite one is over)."""
    return float(np.mean(np.asarray(values) > tol)) if values else 0.0


def judge(weights, config, extents, k, items, rows_out=None) -> dict:
    """items: (image_rgb (H, W, 3) uint8, program label (H, W) long on the
    device, served detections as the program serves them: dicts with
    "class", "roi", "score", "quat_wxyz", "trans"). Returns NUMBERS and
    EXACT -> value; `rows_out`, a list, also gets each detection's readings."""
    dev = extents.device
    ref.set_fp32_exact()
    means = torch.tensor(config["pixel_means"], dtype=torch.float32, device=dev)
    hough = ref.hough_settings(config)
    inlier = hough["inlier_threshold"]
    fx, fy, px, py = float(k[0][0]), float(k[1][1]), float(k[0][2]), float(k[1][2])
    readings = {"label_rel_gap": [], "quat_err": [], "trans_err": []}
    class_set_diff = centre_off = 0

    def note(name, value):
        readings[name].append(float(value))
        if rows_out is not None:
            rows_out.append((name, float(value)))

    for image, label, served in items:
        bgr = torch.as_tensor(image[:, :, ::-1].copy(), device=dev)[None]
        scores, vertex_up, c4, c5 = ref.features_and_maps(weights, bgr, means, "fp32")
        s = scores[0]
        label = label.to(dev).long()
        best = s.amax(-1)
        gap = best - s.gather(-1, label[..., None])[..., 0]
        note("label_rel_gap", (gap / (best - s.amin(-1)).clamp(min=1e-12)).amax())

        slots = {sl["cls"]: sl for sl in ref.class_samples(label, vertex_up[0], extents, k, hough)}
        height, width = label.shape
        # a maximum's votes over a sample's weight: its count of inlier samples
        best_samples = {c: ref.coarse_to_fine_max(sl, height, width, inlier)[0] / sl["w"]
                        for c, sl in slots.items()}
        due = {c for c, n in best_samples.items() if n >= MIN_SHARE * hough["num_samples"]}
        served_classes = {int(d["class"]) for d in served}
        class_set_diff += len((due - served_classes) | (served_classes - set(slots)))
        if rows_out is not None:
            for c, n in best_samples.items():
                rows_out.append(("class", dict(cls=c, max_samples=n, served=c in served_classes)))
        for d in served:
            c = int(d["class"])
            sl = slots.get(c)
            x1, y1, x2, y2 = (float(a) for a in d["roi"])
            cx, cy = float(round((x1 + x2) / 2)), float(round((y1 + y2) / 2))
            v, dsum = (0.0, 0.0) if sl is None else (
                float(a[0]) for a in ref.votes_at(sl, torch.tensor([cx], device=dev),
                                                  torch.tensor([cy], device=dev), inlier))
            if c in due:
                centre_off += v / sl["w"] < CENTRE_TOL * best_samples[c]
            if rows_out is not None and sl is not None:
                rows_out.append(("centre", dict(
                    cls=c, max_samples=best_samples[c], centre_samples=v / sl["w"],
                    served_samples=float(d["score"]) / sl["w"])))
            if v <= 0:
                note("trans_err", math.inf)
                continue
            dist = dsum / v
            t_ref = [(cx - px) / fx * dist, (cy - py) / fy * dist, dist]
            t = [float(a) for a in d["trans"]]
            note("trans_err", math.dist(t, t_ref) / max(math.hypot(*t_ref), 1e-12))
        if served:
            boxes = torch.tensor([d["roi"] for d in served], dtype=torch.float32, device=dev)
            cls = torch.tensor([int(d["class"]) for d in served], dtype=torch.long, device=dev)
            q_ref = ref.pose_quaternions(weights, c4[0], c5[0], boxes, cls, "fp32",
                                         config["pose_pool_size"])
            q = torch.tensor([d["quat_wxyz"] for d in served], dtype=torch.float32, device=dev)
            for e in (q - q_ref).norm(dim=1).tolist():
                note("quat_err", e)
    return {"label_rel_gap": max(readings["label_rel_gap"], default=0.0),
            "quat_far_share": far_share(readings["quat_err"], QUAT_TOL),
            "trans_far_share": far_share(readings["trans_err"], TRANS_TOL),
            "class_set_diff": float(class_set_diff),
            "centre_off": float(centre_off)}
