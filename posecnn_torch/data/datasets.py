"""Dataset readers: YCB-Video (LOV), LINEMOD, the single-object YCB splits
and the demo image set.

The port's copy of `posecnn_tpu/data/datasets.py:28-320`, carried because
`posecnn_tpu.data` imports jax. The on-disk formats are the reference's:

  <prefix>-color.png        RGB image
  <prefix>-depth.png        uint16 depth / factor_depth metres
  <prefix>-label.png        per-pixel class ids
  <prefix>-meta.mat         {'poses' (3,4,N), 'cls_indexes', 'center'
                             (N,2), 'intrinsic_matrix', 'factor_depth'}
  models/<cls>/points.xyz   model point cloud
  extents.txt               per-class 3D extents
  poses/<cls>.txt           the pose bank of `train.syn_sample_pose`

Images are read by PIL; `.mat` meta through `scipy.io`. `core/registry.DATASETS`
maps the names the CLIs take to the classes. The scene-segmentation
readers (`SceneSegDataset` and its subclasses: RGB-D Scenes, ShapeNet
scenes, GMU scenes) read the same layout with frames and labels only, and
`SymDataset` and `YumiDataset` the pose layout with their own classes.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from posecnn_torch.core.registry import DATASETS

_register = DATASETS.register

YCB_CLASSES = (
    "__background__",
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
    "011_banana", "019_pitcher_base", "021_bleach_cleanser", "024_bowl",
    "025_mug", "035_power_drill", "036_wood_block", "037_scissors",
    "040_large_marker", "051_large_clamp", "052_extra_large_clamp",
    "061_foam_brick",
)

# (ref: lov.py:38)
YCB_SYMMETRY = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1],
    np.float32,
)

# ADI-evaluated classes (ref: lov.py:539-541): bowl, wood_block, foam_brick
YCB_ADI_CLASSES = (13, 16, 21)

# (ref: lov.py:32-35)
YCB_CLASS_COLORS = np.array(
    [
        (255, 255, 255), (255, 0, 0), (0, 255, 0), (0, 0, 255),
        (255, 255, 0), (255, 0, 255), (0, 255, 255), (128, 0, 0),
        (0, 128, 0), (0, 0, 128), (128, 128, 0), (128, 0, 128),
        (0, 128, 128), (64, 0, 0), (0, 64, 0), (0, 0, 64), (64, 64, 0),
        (64, 0, 64), (0, 64, 64), (192, 0, 0), (0, 192, 0), (0, 0, 192),
    ],
    np.float32,
)

LINEMOD_CLASSES = (
    "__background__", "ape", "benchvise", "bowl", "camera", "can", "cat",
    "cup", "driller", "duck", "eggbox", "glue", "holepuncher", "iron",
    "lamp", "phone",
)
# published LINEMOD object diameters in meters, classes 1..15 in
# LINEMOD_CLASSES order (benchmark constants, ref: linemod.py:57-59)
LINEMOD_DIAMETERS = (
    0.0,
    0.10209866, 0.24750624, 0.16735486, 0.17249225, 0.20140359,
    0.15454552, 0.12426431, 0.26147178, 0.10899920, 0.16462759,
    0.17588933, 0.14554287, 0.27807812, 0.28260129, 0.21235825,
)
# standard LINEMOD camera intrinsics (ref: per-frame meta
# intrinsic_matrix; the fixed Primesense calibration)
LINEMOD_K = (
    (572.4114, 0.0, 325.2611),
    (0.0, 573.57043, 242.04899),
    (0.0, 0.0, 1.0),
)
# the YCB-Video camera (posecnn_tpu/cli/train_net.py:460-462)
YCB_K = (
    (1066.778, 0.0, 312.9869),
    (0.0, 1067.487, 241.3109),
    (0.0, 0.0, 1.0),
)
# eggbox & glue evaluated with ADD-S (ref: linemod.py:649-653)
LINEMOD_SYMMETRY = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0], np.float32
)


def _read_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


def load_points_xyz(path: str, num_points: Optional[int] = None) -> np.ndarray:
    pts = np.loadtxt(path, dtype=np.float32)
    if num_points is not None and pts.shape[0] > num_points:
        idx = np.linspace(0, pts.shape[0] - 1, num_points).astype(int)
        pts = pts[idx]
    return pts


class PoseDataset:
    """Common reader: frames + class metadata."""

    classes: Sequence[str]
    symmetry: np.ndarray

    def __init__(self, root: str, image_set: str, classes, symmetry, num_points=2620):
        self.root = root
        self.image_set = image_set
        self.classes = classes
        self.symmetry = np.asarray(symmetry, np.float32)
        self.num_points = num_points
        self.num_classes = len(classes)
        self.image_index = self._load_image_set_index()
        self.points = self._load_points()
        self.extents = self._load_extents()

    # ---- per-dataset layout hooks ----
    def _image_set_file(self) -> str:
        return os.path.join(self.root, f"{self.image_set}.txt")

    def _load_image_set_index(self) -> List[str]:
        path = self._image_set_file()
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]

    def _load_extents(self) -> np.ndarray:
        path = os.path.join(self.root, "extents.txt")
        ext = np.zeros((self.num_classes, 3), np.float32)
        if os.path.exists(path):
            ext[1:] = np.loadtxt(path, dtype=np.float32)[: self.num_classes - 1]
        return ext

    def _load_points(self) -> np.ndarray:
        """(C, P, 3) stacked class point clouds (ref: lov.py:141-158;
        row 0 = background zeros)."""
        pts = np.zeros((self.num_classes, self.num_points, 3), np.float32)
        for i, cls in enumerate(self.classes):
            if i == 0:
                continue
            path = os.path.join(self.root, "models", cls, "points.xyz")
            if os.path.exists(path):
                p = load_points_xyz(path)
                n = min(self.num_points, p.shape[0])
                idx = np.linspace(0, p.shape[0] - 1, n).astype(int)
                pts[i, :n] = p[idx]
                if n < self.num_points:  # pad by repetition, keeps ADD exact-ish
                    pts[i, n:] = pts[i, :1]
        return pts

    def subsampled_points(self, num: int) -> np.ndarray:
        idx = np.linspace(0, self.num_points - 1, num).astype(int)
        return self.points[:, idx]

    def load_pose_bank(self):
        """Per-class real-pose banks for TRAIN.SYN_SAMPLE_POSE
        (ref: synthesize.cpp:98-126 loads one 7-float-per-line file per
        model; rows are [qw qx qy qz tx ty tz]). Layout here:
        <root>/poses/<class_name>.txt. Returns a list indexed by class
        id (None where no file exists / background)."""
        bank: List[Optional[np.ndarray]] = [None] * self.num_classes
        for i, cls in enumerate(self.classes):
            if i == 0:
                continue
            path = os.path.join(self.root, "poses", f"{cls}.txt")
            if os.path.exists(path):
                rows = np.loadtxt(path, dtype=np.float32).reshape(-1, 7)
                bank[i] = rows
        return bank

    # ---- frame loading ----
    def frame_prefix(self, index: str) -> str:
        return os.path.join(self.root, "data", index)

    def load_frame(self, index: str) -> dict:
        """Load one RGB-D frame with GT (needs scipy for .mat meta)."""
        prefix = self.frame_prefix(index)
        out = {"color": _read_image(prefix + "-color.png")}
        depth_path = prefix + "-depth.png"
        if os.path.exists(depth_path):
            out["depth_raw"] = _read_image(depth_path)
        label_path = prefix + "-label.png"
        if os.path.exists(label_path):
            out["label"] = _read_image(label_path).astype(np.int32)
        meta_path = prefix + "-meta.mat"
        if os.path.exists(meta_path):
            import scipy.io

            meta = scipy.io.loadmat(meta_path)
            out["meta"] = meta
            factor = float(np.squeeze(meta.get("factor_depth", 1000.0)))
            if "depth_raw" in out:
                out["depth"] = out["depth_raw"].astype(np.float32) / factor
            out["poses"] = meta["poses"]  # (3, 4, N)
            out["cls_indexes"] = np.squeeze(meta["cls_indexes"]).astype(np.int64).reshape(-1)
            out["intrinsic_matrix"] = meta["intrinsic_matrix"].astype(np.float32)
            if "center" in meta:
                out["center"] = meta["center"].astype(np.float32)
        return out


@_register("ycb_video")
@_register("lov")
class YCBVideoDataset(PoseDataset):
    """YCB-Video / LOV (ref: lib/datasets/lov.py)."""

    def __init__(self, root: str, image_set: str = "train", num_points: int = 2620):
        super().__init__(root, image_set, YCB_CLASSES, YCB_SYMMETRY, num_points)

    @property
    def adi_classes(self):
        return YCB_ADI_CLASSES


@_register("linemod")
class LinemodDataset(PoseDataset):
    """LINEMOD (ref: lib/datasets/linemod.py). Per-object image sets
    live under indexes/<cls>_<set>.txt in the reference layout."""

    def __init__(self, root: str, image_set: str = "train", cls: str = "", num_points: int = 2620):
        self.cls = cls
        super().__init__(root, image_set, LINEMOD_CLASSES, LINEMOD_SYMMETRY, num_points)

    def _image_set_file(self) -> str:
        name = f"{self.cls}_{self.image_set}.txt" if self.cls else f"{self.image_set}.txt"
        for sub in ("indexes", "."):
            path = os.path.join(self.root, sub, name)
            if os.path.exists(path):
                return path
        return os.path.join(self.root, name)

    @property
    def diameters(self) -> np.ndarray:
        """(C,) object diameters in meters for the 0.1·d success
        threshold (benchmark constants, ref: linemod.py:57-59,651)."""
        return np.asarray(LINEMOD_DIAMETERS, np.float32)

    @property
    def intrinsic_matrix(self) -> np.ndarray:
        return np.asarray(LINEMOD_K, np.float32)

    @property
    def z_flip_classes(self):
        """Classes with a 180°-Z pose ambiguity in the annotations
        (eggbox; ref: linemod.py:731-751)."""
        return tuple(
            i for i, name in enumerate(self.classes) if name == "eggbox"
        )


@_register("demo")
class DemoDataset:
    """The 5-frame demo fixture (ref: tools/demo.py:108-147,
    data/demo_images). Intrinsics hard-coded as in demo.py:132-133."""

    def __init__(self, root: str):
        self.root = root
        self.classes = YCB_CLASSES
        self.num_classes = len(YCB_CLASSES)
        self.symmetry = YCB_SYMMETRY
        self.intrinsic_matrix = np.array(
            [[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]],
            np.float32,
        )
        self.image_index = sorted(
            f[: -len("-color.png")]
            for f in os.listdir(root)
            if f.endswith("-color.png")
        )

    def load_frame(self, index: str) -> dict:
        prefix = os.path.join(self.root, index)
        out = {"color": _read_image(prefix + "-color.png")}
        dp = prefix + "-depth.png"
        if os.path.exists(dp):
            out["depth_raw"] = _read_image(dp)
            out["depth"] = out["depth_raw"].astype(np.float32) / 10000.0
        out["intrinsic_matrix"] = self.intrinsic_matrix
        return out


@_register("ycb")
@_register("ycb_single")
class YCBSingleDataset(YCBVideoDataset):
    """Single-object YCB splits (ref: lib/datasets/ycb.py,
    ycb_single.py) — same on-disk format as YCB-Video with per-object
    image sets."""

    def __init__(self, root: str, image_set: str = "train", cls: str = "", num_points: int = 2620):
        self.cls = cls
        super().__init__(root, image_set, num_points)

    def _image_set_file(self) -> str:
        name = f"{self.cls}_{self.image_set}.txt" if self.cls else f"{self.image_set}.txt"
        for sub in ("image_sets", "indexes", "."):
            path = os.path.join(self.root, sub, name)
            if os.path.exists(path):
                return path
        return os.path.join(self.root, name)


@_register("lov_single")
class LOVSingleDataset(YCBVideoDataset):
    """Per-object LOV splits (ref: lib/datasets/lov_single.py)."""

    def __init__(self, root: str, image_set: str = "train", cls: str = "", num_points: int = 2620):
        self.cls = cls
        super().__init__(root, image_set, num_points)


SYM_CLASSES = ("__background__", "block_blue", "block_green", "block_red", "block_yellow")


@_register("sym")
class SymDataset(PoseDataset):
    """Symmetric-block toy dataset (ref: lib/datasets/sym.py)."""

    def __init__(self, root: str, image_set: str = "train", num_points: int = 2620):
        super().__init__(root, image_set, SYM_CLASSES,
                         np.ones(len(SYM_CLASSES), np.float32), num_points)


YUMI_CLASSES = ("__background__", "cube")


@_register("yumi")
class YumiDataset(PoseDataset):
    """YuMi robot-cell dataset (ref: lib/datasets/yumi.py)."""

    def __init__(self, root: str, image_set: str = "train", num_points: int = 2620):
        super().__init__(root, image_set, YUMI_CLASSES,
                         np.zeros(len(YUMI_CLASSES), np.float32), num_points)


class SceneSegDataset(PoseDataset):
    """Scene-segmentation datasets without pose models (ref:
    lib/datasets/rgbd_scene.py, shapenet_scene.py, shapenet_single.py,
    gmu_scene.py): frames and labels only."""

    def __init__(self, root: str, image_set: str, classes):
        super().__init__(root, image_set, classes, np.zeros(len(classes), np.float32),
                         num_points=1)


@_register("rgbd_scene")
class RGBDSceneDataset(SceneSegDataset):
    CLASSES = ("__background__", "bowl", "cap", "cereal_box", "coffee_mug",
               "coffee_table", "office_chair", "soda_can", "sofa", "table")

    def __init__(self, root: str, image_set: str = "train"):
        super().__init__(root, image_set, self.CLASSES)


@_register("shapenet_scene")
@_register("shapenet_single")
class ShapeNetSceneDataset(SceneSegDataset):
    CLASSES = ("__background__",) + tuple(f"class_{i}" for i in range(1, 8))

    def __init__(self, root: str, image_set: str = "train"):
        super().__init__(root, image_set, self.CLASSES)


@_register("gmu_scene")
class GMUSceneDataset(SceneSegDataset):
    CLASSES = ("__background__", "coca_cola", "coffee_mate", "honey_bunches",
               "hunts_sauce", "mahatma_rice", "nature_v1", "nature_v2",
               "palmolive_orange", "pop_secret", "pringles_bbq", "red_bull")

    def __init__(self, root: str, image_set: str = "train"):
        super().__init__(root, image_set, self.CLASSES)
