"""COCO-format export of label maps and GT poses.

The port's copy of `posecnn_tpu/data/coco_export.py` (numpy and scipy,
carried because `posecnn_tpu.data` imports jax); `tests/test_torch_coco_export.py`
holds every helper and the CLI's JSON equal to the original's. Per frame,
each present GT object's label mask becomes one COCO annotation (polygon
segmentation by a Moore-neighbour boundary trace and Douglas-Peucker
simplification at eps_frac × perimeter, or an uncompressed column-major
RLE; bbox; area) carrying the reference's `meta` payload (object centre,
7-d pose, intrinsics), and each image records its depth file and depth
factor (ref: my_tools/ycb_to_coco.py, my_tools/coco_annotation.py). The
file's `info` block is the original's, so the two packages write the same
JSON.
"""

from __future__ import annotations

import copy
import json
from typing import List, Optional, Sequence

import numpy as np

# Moore neighborhood in clockwise order starting from "west"
# (dy, dx); tracing keeps the object on the right-hand side.
_MOORE = np.array(
    [(0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1)],
    dtype=np.int64,
)


def largest_components(mask: np.ndarray, max_components: int = 1) -> List[np.ndarray]:
    """Split a binary mask into its largest connected components
    (8-connected), biggest first (ref sorts contours by area,
    ycb_to_coco.py:17-18)."""
    from scipy import ndimage

    labeled, n = ndimage.label(mask, structure=np.ones((3, 3), dtype=np.int32))
    if n == 0:
        return []
    sizes = ndimage.sum_labels(np.ones_like(labeled), labeled, index=np.arange(1, n + 1))
    order = np.argsort(-sizes)[:max_components]
    return [labeled == (idx + 1) for idx in order]


def trace_boundary(mask: np.ndarray) -> np.ndarray:
    """Outer boundary of a single 8-connected component as an (N, 2)
    array of (x, y) pixel coordinates, clockwise (image coordinates).

    Moore-neighbor tracing with backtracking; terminates on re-entering
    the start pixel from the original backtrack direction (Jacob's
    stopping criterion) or after a hard iteration cap.
    """
    mask = np.asarray(mask, dtype=bool)
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    # start at the first foreground pixel in scanline order; its west
    # neighbor is guaranteed background (scanline order) → valid backtrack
    sy, sx = int(ys[0]), int(xs[0])
    if ys.size == 1:
        return np.array([[sx, sy]], dtype=np.int64)
    h, w = mask.shape

    def neighbor(cy, cx, k):
        dy, dx = _MOORE[k % 8]
        ny, nx = cy + int(dy), cx + int(dx)
        inside = 0 <= ny < h and 0 <= nx < w
        return ny, nx, inside and bool(mask[ny, nx])

    boundary = [(sx, sy)]
    cy, cx = sy, sx
    back = 0  # index into _MOORE of the backtrack direction (west)
    start_back = back
    cap = 4 * int(ys.size) + 8
    for _ in range(cap):
        found = False
        for step in range(1, 9):
            k = (back + step) % 8
            ny, nx, fg = neighbor(cy, cx, k)
            if fg:
                # new backtrack = direction pointing from the new pixel
                # to the last scanned background neighbor
                prev_k = (back + step - 1) % 8
                by = cy + int(_MOORE[prev_k][0]) - ny
                bx = cx + int(_MOORE[prev_k][1]) - nx
                back = int(np.nonzero((_MOORE == (by, bx)).all(axis=1))[0][0])
                cy, cx = ny, nx
                found = True
                break
        if not found:  # isolated pixel (shouldn't reach here; guarded above)
            break
        if (cy, cx) == (sy, sx) and back == start_back:
            break
        boundary.append((cx, cy))
    return np.array(boundary, dtype=np.int64)


def simplify_polygon(poly: np.ndarray, epsilon: float) -> np.ndarray:
    """Douglas-Peucker polyline simplification (iterative), mirroring
    cv2.approxPolyDP's epsilon semantics (ref ycb_to_coco.py:21-27:
    epsilon = eps * arcLength)."""
    pts = np.asarray(poly, dtype=np.float64)
    n = len(pts)
    if n < 3 or epsilon <= 0:
        return np.asarray(poly)
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[n - 1] = True
    stack = [(0, n - 1)]
    while stack:
        i0, i1 = stack.pop()
        if i1 <= i0 + 1:
            continue
        seg = pts[i1] - pts[i0]
        seg_len = np.hypot(*seg)
        mid = pts[i0 + 1 : i1]
        if seg_len < 1e-12:
            dist = np.hypot(*(mid - pts[i0]).T)
        else:
            # perpendicular distance to the chord (2D cross product)
            rel = mid - pts[i0]
            dist = np.abs(seg[0] * rel[:, 1] - seg[1] * rel[:, 0]) / seg_len
        j = int(np.argmax(dist))
        if dist[j] > epsilon:
            jj = i0 + 1 + j
            keep[jj] = True
            stack.append((i0, jj))
            stack.append((jj, i1))
    return np.asarray(poly)[keep]


def mask_to_polygons(
    mask: np.ndarray,
    eps_frac: float = 0.003,
    max_components: int = 3,
    min_points: int = 3,
) -> List[np.ndarray]:
    """Binary mask → list of simplified (N, 2) boundary polygons,
    largest component first (ref ycb_to_coco.py:9-31: contours sorted
    by area, approxPolyDP at eps·perimeter, <3-point polygons dropped)."""
    polys = []
    for comp in largest_components(mask, max_components=max_components):
        boundary = trace_boundary(comp)
        if len(boundary) < min_points:
            continue
        closed = np.vstack([boundary, boundary[:1]])
        perimeter = float(np.sum(np.hypot(*np.diff(closed, axis=0).T)))
        poly = simplify_polygon(boundary, eps_frac * perimeter)
        if len(poly) >= min_points:
            polys.append(poly)
    return polys


def mask_to_rle(mask: np.ndarray) -> dict:
    """COCO uncompressed RLE: column-major run lengths, starting with
    the count of zeros."""
    m = np.asarray(mask, dtype=np.uint8).flatten(order="F")
    change = np.nonzero(np.diff(m))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [m.size]])).tolist()
    if m.size and m[0] == 1:  # counts must start with a zero-run
        runs = [0] + runs
    return {"counts": runs, "size": [int(mask.shape[0]), int(mask.shape[1])]}


def rle_to_mask(rle: dict) -> np.ndarray:
    """Inverse of :func:`mask_to_rle` (used by tests / consumers)."""
    h, w = rle["size"]
    flat = np.zeros(h * w, dtype=bool)
    pos = 0
    val = False
    for run in rle["counts"]:
        flat[pos : pos + run] = val
        pos += run
        val = not val
    return flat.reshape((h, w), order="F")


def polygon_area(poly: np.ndarray) -> float:
    """Shoelace area (cv2.contourArea equivalent, ref
    coco_annotation.py:88)."""
    p = np.asarray(poly, dtype=np.float64)
    if len(p) < 3:
        return 0.0
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


class CocoWriter:
    """COCO annotation-file builder (ref: CocoAnnotationClass,
    my_tools/coco_annotation.py:13-128 — 1-indexed categories, custom
    ``meta`` fields on images and annotations)."""

    def __init__(self, classes: Sequence[str], supercategory: str = ""):
        self.classes = list(classes)
        self.data = {
            "info": {"year": 2026, "version": "", "description": "posecnn_tpu export"},
            "images": [],
            "annotations": [],
            "categories": [
                {"id": i + 1, "name": c, "supercategory": supercategory}
                for i, c in enumerate(self.classes)
            ],
            "licenses": [{"id": 1, "name": "", "url": ""}],
        }

    def add_image(
        self,
        image_id: int,
        width: int,
        height: int,
        file_name: str,
        depth_name: str = "",
        factor_depth: float = 10000.0,
    ) -> None:
        # the reference records (depth file, factor_depth) as the image
        # meta payload (ycb_to_coco.py:163-165)
        self.data["images"].append(
            {
                "id": image_id,
                "width": int(width),
                "height": int(height),
                "file_name": file_name,
                "license": 1,
                "meta": {"depth_file": depth_name, "factor_depth": factor_depth},
            }
        )

    def add_annotation(
        self,
        annot_id: int,
        image_id: int,
        category_id: int,
        polygons: Optional[List[np.ndarray]] = None,
        rle: Optional[dict] = None,
        meta: Optional[dict] = None,
        iscrowd: int = 0,
    ) -> None:
        if polygons:
            concat = np.concatenate([np.asarray(p, np.float64) for p in polygons])
            lo, hi = concat.min(axis=0), concat.max(axis=0)
            bbox = [float(lo[0]), float(lo[1]), float(hi[0] - lo[0]), float(hi[1] - lo[1])]
            seg = [np.asarray(p, np.float64).flatten().tolist() for p in polygons]
            area = float(sum(polygon_area(p) for p in polygons))
        elif rle is not None:
            mask = rle_to_mask(rle)
            ys, xs = np.nonzero(mask)
            if ys.size == 0:
                return
            bbox = [
                float(xs.min()),
                float(ys.min()),
                float(xs.max() - xs.min()),
                float(ys.max() - ys.min()),
            ]
            seg = rle
            area = float(ys.size)
        else:
            raise ValueError("add_annotation needs polygons or rle")
        self.data["annotations"].append(
            {
                "id": annot_id,
                "image_id": image_id,
                "category_id": int(category_id),
                "segmentation": seg,
                "area": area,
                "bbox": bbox,
                "iscrowd": iscrowd,
                "meta": meta or {},
            }
        )

    def get_annot_json(self) -> dict:
        return copy.deepcopy(self.data)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.data, f)


def frame_annotations(
    writer: CocoWriter,
    image_id: int,
    next_annot_id: int,
    label: np.ndarray,
    gt_poses: np.ndarray,
    intrinsics: np.ndarray,
    segmentation: str = "polygon",
    eps_frac: float = 0.003,
) -> int:
    """Emit one frame's annotations: one per present GT object, with
    the reference's meta payload {center, pose, intrinsic_matrix}
    (ycb_to_coco.py:140, using the pose-blob row layout of this
    framework: cls at col 1, center at cols 2:4, quat at 6:10, trans
    at 10:13). Returns the next free annotation id."""
    k_list = np.asarray(intrinsics, np.float64).tolist()
    for row in np.asarray(gt_poses, np.float64):
        cls = int(row[1])
        if cls <= 0:
            continue
        mask = label == cls
        if not mask.any():
            continue
        meta = {
            "center": [float(row[2]), float(row[3])],
            "pose": row[6:13].tolist(),
            "intrinsic_matrix": k_list,
        }
        if segmentation == "rle":
            writer.add_annotation(
                next_annot_id, image_id, cls, rle=mask_to_rle(mask), meta=meta
            )
        else:
            polys = mask_to_polygons(mask, eps_frac=eps_frac)
            if not polys:
                continue
            writer.add_annotation(
                next_annot_id, image_id, cls, polygons=polys, meta=meta
            )
        next_annot_id += 1
    return next_annot_id
