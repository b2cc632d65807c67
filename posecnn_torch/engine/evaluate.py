"""Evaluation: segmentation IoU, 6D pose errors and their aggregates
(counterpart of `posecnn_tpu/engine/evaluate.py:30-332`).

  seg IoU      confusion-histogram diagonal over union
  YCB success  ADD(-S) < 0.1·‖extents‖₂; symmetric classes use ADD-S
  LINEMOD      ADD(-S) < 0.1·diameter, reprojection < 5 px, and the
               180°-about-z retry for classes with that ambiguity
  AUC          area under accuracy vs threshold on [0, 0.1] m

`PoseEvaluator` matches each image's detections to its GT poses on the
host, computes every matched pair's errors on its `device` in one batched
call, and accumulates them on the host in numpy, as the JAX evaluator
does. That call is `pair_errors`, the counterpart of the JAX evaluator's
jitted `_pose_errors_one` (`posecnn_tpu/engine/evaluate.py:42`) batched
over an image's pairs, compiled with `utils/graph.compile_static`: the
pairs are padded (`padded_pairs`, repeating the last) to a power of two of
at least 8 rows, so a run captures few graphs, and every row carries a
z-flip flag, so the 180° retry runs for every row inside the one program
and is kept per row. `detection_ap` scores the detection family's boxes
(AP@IoU).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from posecnn_torch.utils import pose_error
from posecnn_torch.utils.graph import compile_static, device_constant
from posecnn_torch.utils.quaternion import quat_mul, quat_to_mat


def fast_hist(gt: np.ndarray, pred: np.ndarray, n: int) -> np.ndarray:
    """(n, n) confusion histogram of GT rows against predicted columns."""
    k = (gt >= 0) & (gt < n)
    return np.bincount(n * gt[k].astype(int) + pred[k], minlength=n**2).reshape(n, n)


def iou_from_hist(hist: np.ndarray) -> np.ndarray:
    """Per-class IoU of a confusion histogram."""
    denom = hist.sum(1) + hist.sum(0) - np.diag(hist)
    return np.diag(hist) / np.maximum(denom, 1e-10)


def pose_errors(q_est, t_est, q_gt, t_gt, pts, k):
    """ADD, ADD-S, RE, TE and reprojection error of B pose pairs:
    quaternions (B, 4), translations (B, 3), model points (B, P, 3),
    intrinsics (3, 3). Each (B,) fp32."""
    r_est, r_gt = quat_to_mat(q_est), quat_to_mat(q_gt)
    kb = k.expand(q_est.shape[0], 3, 3)
    return (pose_error.add_error(r_est, t_est, r_gt, t_gt, pts),
            pose_error.adi_error(r_est, t_est, r_gt, t_gt, pts),
            pose_error.re(r_est, r_gt),
            pose_error.te(t_est, t_gt),
            pose_error.reproj_error(kb, r_est, t_est, r_gt, t_gt, pts))


# 180° about the object z axis (wxyz), the LINEMOD eggbox ambiguity
_Z_FLIP = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def pair_errors(q_est, t_est, q_gt, t_gt, cls, flip, points, k):
    """The (R, 5) errors (ADD, ADD-S, RE, TE, reprojection) of R pairs:
    quaternions (R, 4), translations (R, 3), classes cls (R,) int64 into
    points (C, P, 3), flip (R,) bool, intrinsics k (3, 3). A row with flip
    keeps its errors against the GT turned 180° about z where that ADD is
    lower (the retry runs for every row). The program `PoseEvaluator`
    compiles: it reads nothing on the host."""
    pts = points[cls]
    errs = torch.stack(pose_errors(q_est, t_est, q_gt, t_gt, pts, k), -1)
    q_flip = quat_mul(q_gt, device_constant(_Z_FLIP.tolist(), q_gt.device))
    alt = torch.stack(pose_errors(q_est, t_est, q_flip, t_gt, pts, k), -1)
    better = flip & (alt[:, 0] < errs[:, 0])
    return torch.where(better[:, None], alt, errs)


def padded_pairs(n: int) -> int:
    """The rows `pair_errors` runs at for n pairs: the next power of two,
    at least 8, so that a run captures one graph per power."""
    return max(8, 1 << max(n - 1, 0).bit_length())


@dataclass
class PoseEvaluator:
    """Accumulates detections against GT across images and reports the
    aggregate metrics. By default each GT is matched to the first
    detection of its class (one instance per class, as the reference
    evaluation assumes); with `instance_matching`, same-class detections
    and GTs are matched greedily by translation distance."""

    num_classes: int
    points: np.ndarray  # (C, P, 3)
    extents: np.ndarray  # (C, 3)
    symmetric_classes: tuple = ()  # classes scored with ADD-S
    z_flip_classes: tuple = ()  # classes with the 180° z ambiguity
    diameters: Optional[np.ndarray] = None  # (C,): LINEMOD's 0.1·diameter threshold
    intrinsics: Optional[np.ndarray] = None  # (3, 3) for the reprojection error
    reproj_threshold_px: float = 5.0
    instance_matching: bool = False
    device: str = "cpu"  # where the per-image errors are computed
    errors_add: Dict[int, List[float]] = field(default_factory=dict)
    errors_adi: Dict[int, List[float]] = field(default_factory=dict)
    errors_rot: Dict[int, List[float]] = field(default_factory=dict)
    errors_trans: Dict[int, List[float]] = field(default_factory=dict)
    errors_reproj: Dict[int, List[float]] = field(default_factory=dict)
    num_gt: Dict[int, int] = field(default_factory=dict)
    num_images: int = 0
    seg_hist: Optional[np.ndarray] = None

    def __post_init__(self):
        self.seg_hist = np.zeros((self.num_classes, self.num_classes), np.int64)
        if self.intrinsics is None:
            self.intrinsics = np.eye(3, dtype=np.float32)
        dev = torch.device(self.device)
        self._points = torch.as_tensor(np.asarray(self.points, np.float32), device=dev)
        self._k = torch.as_tensor(np.asarray(self.intrinsics, np.float32), device=dev)
        self._errors = compile_static(pair_errors)  # one CUDA graph per padded row count

    def add_segmentation(self, gt_label: np.ndarray, pred_label: np.ndarray):
        self.seg_hist += fast_hist(gt_label.flatten(), pred_label.flatten(), self.num_classes)

    def _match(self, detections, gts):
        """The image's records in accumulation order: (cls, None) for a
        missed GT, (cls, (q_est, t_est, q_gt, t_gt)) for a matched pair."""
        records = []
        if not self.instance_matching:
            det_by_cls = {}
            for cls, q, t in detections:
                det_by_cls.setdefault(int(cls), (q, t))
            for cls, q_gt, t_gt in gts:
                cls = int(cls)
                self.num_gt[cls] = self.num_gt.get(cls, 0) + 1
                pair = det_by_cls.get(cls)
                records.append((cls, None if pair is None else (*pair, q_gt, t_gt)))
            return records

        dets_by_cls: Dict[int, list] = {}
        for cls, q, t in detections:
            dets_by_cls.setdefault(int(cls), []).append((q, np.asarray(t, np.float64)))
        gts_by_cls: Dict[int, list] = {}
        for cls, q_gt, t_gt in gts:
            gts_by_cls.setdefault(int(cls), []).append((q_gt, np.asarray(t_gt, np.float64)))
        for cls, gts_c in gts_by_cls.items():
            self.num_gt[cls] = self.num_gt.get(cls, 0) + len(gts_c)
            dets_c = dets_by_cls.get(cls, [])
            if not dets_c:
                records.extend((cls, None) for _ in gts_c)
                continue
            # greedy closest translations first, each detection used once;
            # a NaN translation (a degenerate box fit) matches nothing
            dist = np.array([[np.linalg.norm(t_d - t_g) for _, t_g in gts_c] for _, t_d in dets_c])
            dist = np.nan_to_num(dist, nan=np.inf, posinf=np.inf)
            matched = set()
            while True:
                i, j = np.unravel_index(np.argmin(dist), dist.shape)
                if not np.isfinite(dist[i, j]):
                    break
                records.append((cls, (*dets_c[i], *gts_c[j])))
                matched.add(j)
                dist[i, :] = np.inf
                dist[:, j] = np.inf
            records.extend((cls, None) for j in range(len(gts_c)) if j not in matched)
        return records

    def pair_inputs(self, pairs) -> tuple:
        """`pair_errors`' arguments for (cls, q_est, t_est, q_gt, t_gt)
        pairs on the device, padded on the host to `padded_pairs` rows by
        repeating the last pair."""
        dev = self._points.device
        n = len(pairs)
        padded = list(pairs) + [pairs[-1]] * (padded_pairs(n) - n)

        def column(i, dtype=np.float32):
            return torch.from_numpy(np.stack([np.asarray(p[i], dtype) for p in padded])).to(dev)

        cls = torch.from_numpy(np.asarray([p[0] for p in padded], np.int64)).to(dev)
        flip = torch.from_numpy(np.asarray([p[0] in self.z_flip_classes for p in padded])).to(dev)
        return column(1), column(2), column(3), column(4), cls, flip, self._points, self._k

    def _pair_errors(self, pairs):
        """(len(pairs), 5) errors of (cls, q_est, t_est, q_gt, t_gt) pairs:
        one call of the compiled `pair_errors` on the padded rows, with the
        z-flip retry for the z-flip classes, the real rows fetched."""
        return self._errors(*self.pair_inputs(pairs)).cpu().numpy()[:len(pairs)]

    def add_image(self, detections: list, gts: list):
        """detections, gts: [(cls, quat (4,), t (3,))]. An unmatched GT
        records an infinite error."""
        self.num_images += 1
        records = self._match(detections, gts)
        pairs = [(cls, *pair) for cls, pair in records if pair is not None]
        errs = iter(self._pair_errors(pairs) if pairs else ())
        accs = (self.errors_add, self.errors_adi, self.errors_rot, self.errors_trans,
                self.errors_reproj)
        for cls, pair in records:
            values = [np.inf] * 5 if pair is None else [float(e) for e in next(errs)]
            for acc, value in zip(accs, values):
                acc.setdefault(cls, []).append(value)

    def _metric_errors(self, cls: int) -> List[float]:
        if cls in self.symmetric_classes:
            return self.errors_adi.get(cls, [])
        return self.errors_add.get(cls, [])

    def summarize(self, auc_max: float = 0.1) -> dict:
        """Per-class and overall metrics, each with its sample size
        (`num_images`, and `count` GT instances per class)."""

        def auc(errors):
            return float(pose_error.auc_of_errors(torch.as_tensor(np.asarray(errors, np.float32)),
                                                  max_threshold=auc_max))

        out = {"per_class": {}, "num_images": int(self.num_images)}
        all_err, all_err_s = [], []
        for cls in sorted(self.num_gt):
            errs = np.asarray(self._metric_errors(cls))
            errs_s = np.asarray(self.errors_adi.get(cls, []))
            if errs.size == 0:
                continue
            if self.diameters is not None:
                thresh = 0.1 * float(self.diameters[cls])
            else:
                thresh = 0.1 * np.linalg.norm(self.extents[cls])
            finite_rot = [e for e in self.errors_rot[cls] if np.isfinite(e)]
            finite_trans = [e for e in self.errors_trans[cls] if np.isfinite(e)]
            row = {
                "count": int(self.num_gt[cls]),
                "success_rate": float((errs < thresh).mean()),
                "add_auc": auc(errs),
                "adds_auc": auc(errs_s),
                "mean_rot_deg": float(np.mean(finite_rot or [np.inf])),
                "mean_trans_m": float(np.mean(finite_trans or [np.inf])),
            }
            reproj = np.asarray(self.errors_reproj.get(cls, []))
            if reproj.size:
                row["reproj_success_rate"] = float((reproj < self.reproj_threshold_px).mean())
            out["per_class"][cls] = row
            all_err.extend(errs.tolist())
            all_err_s.extend(errs_s.tolist())
        if all_err:
            out["add_auc"] = auc(all_err)
            out["adds_auc"] = auc(all_err_s)
        iou = iou_from_hist(self.seg_hist)
        out["seg_iou_per_class"] = iou.tolist()
        observed = self.seg_hist.sum(1) > 0
        out["seg_mean_iou"] = float(iou[observed].mean()) if observed.any() else 0.0
        return out


def format_per_class_table(summary: dict, class_names=None) -> str:
    """The per-class pose-accuracy report: one row per class with its GT
    count, ADD(-S) success, AUCs, mean rotation and translation errors and
    reprojection success where recorded; then an ALL row with the image
    count."""
    rows = []
    head = (
        f"{'class':<22}{'n':>6}{'succ':>8}{'add_auc':>9}{'adds_auc':>10}"
        f"{'rot_deg':>9}{'trans_m':>9}{'reproj':>8}"
    )
    rows.append(head)
    rows.append("-" * len(head))
    for cls, r in sorted(summary.get("per_class", {}).items(), key=lambda kv: int(kv[0])):
        name = (
            class_names[int(cls)]
            if class_names is not None and int(cls) < len(class_names)
            else str(cls)
        )
        rot = r.get("mean_rot_deg", float("inf"))
        trans = r.get("mean_trans_m", float("inf"))
        rp = r.get("reproj_success_rate")
        rows.append(
            f"{name:<22}{r['count']:>6}{r['success_rate']:>8.3f}"
            f"{r['add_auc']:>9.3f}{r['adds_auc']:>10.3f}"
            f"{rot:>9.1f}{trans:>9.3f}"
            + (f"{rp:>8.3f}" if rp is not None else f"{'-':>8}")
        )
    mean_s = np.mean([r["success_rate"] for r in summary.get("per_class", {}).values()] or [0.0])
    rows.append("-" * len(head))
    rows.append(
        f"{'ALL':<22}{summary.get('num_images', 0):>6}{mean_s:>8.3f}"
        f"{summary.get('add_auc', 0.0):>9.3f}{summary.get('adds_auc', 0.0):>10.3f}"
        f"  (n = images; per-class n = GT instances)"
    )
    return "\n".join(rows)


def extract_detections(
    hough_rois, poses_init, poses_pred, valid, num_classes: int, *, with_indices=False
):
    """Fixed-shape outputs (numpy arrays) → (cls, quat, t) detections:
    translation from the Hough initial pose, rotation from the RoI's own
    class quaternion (or the initial one where that is ~0). Ordered by
    vote score, descending. With `with_indices` each row also carries
    its RoI index: (cls, quat, t, i)."""
    rois = np.asarray(hough_rois)
    init = np.asarray(poses_init)
    quats = np.asarray(poses_pred)
    valid = np.asarray(valid)
    dets = []
    for i in range(rois.shape[0]):
        if not valid[i]:
            continue
        cls = int(rois[i, 1])
        q = quats[i, 4 * cls : 4 * cls + 4]
        n = np.linalg.norm(q)
        q = q / n if n > 1e-6 else init[i, :4]
        dets.append((cls, q, init[i, 4:7], i))
    dets.sort(key=lambda d: -float(rois[d[3], 6]))
    if with_indices:
        return dets
    return [(c, q, t) for c, q, t, _ in dets]


def _box_iou_np(a, b) -> float:
    """IoU of two xyxy boxes without the +1 pixel convention (AP's)."""
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def detection_ap(all_dets: list, all_gts: list, num_classes: int,
                 iou_threshold: float = 0.5) -> dict:
    """VOC-style average precision of box detections, greedy-matched at
    `iou_threshold` (`posecnn_tpu/engine/evaluate.py:335`). all_dets: per
    image a list of (cls, score, box4 xyxy); all_gts: per image a list of
    (cls, box4). Classes without GT are left out. Returns {"map": float,
    "per_class": {cls: ap}}."""
    per_class = {}
    for c in range(1, num_classes):
        npos = sum(1 for gts in all_gts for g in gts if int(g[0]) == c)
        if npos == 0:
            continue
        rows = [(float(score), i, np.asarray(box, np.float64))
                for i, dets in enumerate(all_dets) for cls, score, box in dets if int(cls) == c]
        rows.sort(key=lambda r: -r[0])  # stable: equal scores keep image order
        matched = [set() for _ in all_gts]
        tp = np.zeros(len(rows))
        fp = np.zeros(len(rows))
        for r, (_, i, box) in enumerate(rows):
            best, best_j = 0.0, -1
            for j, g in enumerate(all_gts[i]):
                if int(g[0]) != c:
                    continue
                ov = _box_iou_np(box, np.asarray(g[1], np.float64))
                if ov > best:
                    best, best_j = ov, j
            if best >= iou_threshold and best_j not in matched[i]:
                tp[r] = 1
                matched[i].add(best_j)
            else:
                fp[r] = 1
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / npos
        precision = ctp / np.maximum(ctp + cfp, 1e-10)
        # the precision envelope, then the area under the PR curve
        mrec = np.concatenate([[0.0], recall, [1.0]])
        mpre = np.concatenate([[0.0], precision, [0.0]])
        for k in range(len(mpre) - 2, -1, -1):
            mpre[k] = max(mpre[k], mpre[k + 1])
        idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
        per_class[c] = float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    mean_ap = float(np.mean(list(per_class.values()))) if per_class else 0.0
    return {"map": mean_ap, "per_class": per_class}
