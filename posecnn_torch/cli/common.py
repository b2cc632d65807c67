"""Shared CLI plumbing (counterpart of `posecnn_tpu/cli/common.py:14-130`)."""

from __future__ import annotations

import argparse
import glob
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from posecnn_torch.core.config import Config, cfg_from_dict, cfg_from_file
from posecnn_torch.data import datasets
from posecnn_torch.data.procedural import (
    colorize_model_library,
    fill_missing_points,
    load_background_pool,
    make_procedural_objects,
)
from posecnn_torch.ops.nms import per_class_suppression


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", dest="cfg_file", default=None, help="config YAML (ref --cfg)")
    p.add_argument("--device", default="cuda",
                   help="torch device; the default 'cuda' fails when no card is present")
    p.add_argument("--rand", action="store_true",
                   help="do not fix the rng seed (accepted and not read, as in the JAX CLIs)")
    p.add_argument(
        "--set",
        dest="set_cfgs",
        nargs="*",
        default=[],
        help="config overrides key=value (dots for nesting)",
    )
    return p


def load_config(args) -> Config:
    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    overrides: dict = {}
    for kv in args.set_cfgs:
        key, _, value = kv.partition("=")
        node = overrides
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        import yaml

        node[parts[-1]] = yaml.safe_load(value)
    if overrides:
        cfg = cfg_from_dict(overrides, base=cfg)
    return cfg


def setup_device(name: str) -> torch.device:
    """The torch device to run on, and the fp32 precision policy.

    Raises when a CUDA device is asked for and there is none: nothing
    falls back to the CPU. TF32 is switched off for both matmuls and
    cuDNN convolutions, so the fp32 parts of the model (fc8, Hough
    glue, and every conv on the CPU-parity path) run in full fp32; the
    bf16 compute of the trunk and heads does not depend on it."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def forward_with_suppression(model, data, extents, meta, nms_threshold: float, **forward_kw):
    """The PoseCNN forward and NMS's device part over its Hough RoIs
    (`ops/nms.per_class_suppression`): the program that `serve`, `demo`
    and `test_net` compile (`utils/graph.compile_static`), as the JAX CLIs
    jit the forward with its `nms_per_class`. Returns (outputs,
    suppression); `ops/nms.greedy_keep(suppression)` is the keep mask."""
    out = model(data, extents, meta, **forward_kw)
    return out, per_class_suppression(out.hough.rois, nms_threshold, out.hough.valid)


def _coerce_flag(value, like):
    """A checkpoint flag as the type of the cfg default. Bools accept
    only bools or the strings 'True'/'False' (bool('False') is True)."""
    if isinstance(like, bool):
        if isinstance(value, str):
            if value not in ("True", "False"):
                raise ValueError(f"cannot read {value!r} as a bool")
            return value == "True"
        return bool(value)
    return type(like)(value)


def head_flags_from_ckpt(cfg, ckpt_path):
    """Pose-head flags for eval/serve, taken from the checkpoint's
    recorded metadata when present (they change the forward pass at
    identical parameter shapes), else from the cfg."""
    flags = {
        "norm_features": bool(cfg.train.norm_features),
        "quat_activation": str(cfg.train.quat_activation),
        "pose_pool_size": int(cfg.train.pose_pool_size),
    }
    if not ckpt_path:
        return flags
    from posecnn_torch.core.weights import read_ckpt_meta

    meta = read_ckpt_meta(ckpt_path)
    if not meta:
        print(
            "WARNING: checkpoint records no head metadata; trusting cfg head "
            f"flags {flags} — results are wrong if it was trained under others"
        )
        return flags
    for k, cur in flags.items():
        if k not in meta:
            continue
        v = _coerce_flag(meta[k], cur)
        if v != cur:
            print(f"checkpoint head flag {k}={v!r} overrides cfg {cur!r}")
        flags[k] = v
    return flags


def class_data_from_dataset(ds, num_points: int):
    """(points (C, num_points, 3) or None, extents (C, 3) or None,
    symmetry (C,)) of a dataset reader."""
    points = ds.subsampled_points(num_points) if hasattr(ds, "subsampled_points") else None
    return points, ds.extents if hasattr(ds, "extents") else None, np.asarray(ds.symmetry)


def data_flags_from_ckpt(cfg, ckpt_path):
    """The appearance flags of the rendered class library (orient_paint,
    paint_version), taken from the checkpoint's recorded metadata when
    present, else from the cfg: evaluating a checkpoint under another
    paint than it was trained with degrades its poses silently. Returns
    keyword arguments of `colorize_model_library` / `fill_missing_points`."""
    flags = {
        "orient_detail": bool(cfg.train.orient_paint),
        "paint_version": int(cfg.train.paint_version),
    }
    if not ckpt_path:
        return flags
    from posecnn_torch.core.weights import read_ckpt_meta

    meta = read_ckpt_meta(ckpt_path)
    for src, dst in (("orient_paint", "orient_detail"), ("paint_version", "paint_version")):
        if meta and src in meta:
            v = _coerce_flag(meta[src], flags[dst])
            if v != flags[dst]:
                print(f"checkpoint data flag {src}={v!r} overrides cfg {flags[dst]!r}")
            flags[dst] = v
    return flags


YCB_K = np.asarray(datasets.YCB_K, np.float32)


class ClassGeometry(NamedTuple):
    """The class library a run renders, trains and scores with."""

    num_classes: int
    points: np.ndarray  # (C, P, 3) model clouds
    extents: np.ndarray  # (C, 3)
    symmetry: np.ndarray  # (C,)
    colors: np.ndarray  # (C, P, 3) render paint
    normals: np.ndarray  # (C, P, 3)
    k: np.ndarray  # (3, 3) the intrinsics of the renders, unscaled
    ds: Optional[object] = None  # the YCB-Video reader, with its frames and pose bank
    linemod: Optional[object] = None  # the LINEMOD reader
    linemod_index: int = 0  # the LINEMOD object's class id in LINEMOD_CLASSES


def class_geometry(args, cfg, orient_detail: bool, paint_version: int) -> ClassGeometry:
    """The class library of `--dataset` (`posecnn_tpu/cli/train_net.py:418-478`,
    `cli/test_net.py:93-160`):

      linemod     background + the `--cls` object (2 classes): LINEMOD's
                  extents and symmetry, its clouds from `models/` or
                  stand-ins at its extents (`fill_missing_points`), its camera
      ycb_video, lov, or synthetic with a `--data_root` holding `models/`:
                  the YCB-Video reader of `--image_set` (22 classes), its
                  xyz clouds painted by `colorize_model_library`, YCB's camera
      synthetic   the procedural library of `train.num_classes` classes,
                  a 500 px focal length at the centre of the training size
    """
    if args.dataset == "linemod":
        lm = datasets.DATASETS.get("linemod")(args.data_root, args.image_set, cls=args.cls)
        ci = list(lm.classes).index(args.cls) if args.cls else 1
        pts, cols, nrms = fill_missing_points(lm.points, lm.extents, orient_detail=orient_detail,
                                              paint_version=paint_version)
        pick = [0, ci]
        return ClassGeometry(2, pts[pick], lm.extents[pick],
                             np.asarray([0.0, lm.symmetry[ci]], np.float32), cols[pick],
                             nrms[pick], lm.intrinsic_matrix, linemod=lm, linemod_index=ci)
    if args.dataset in ("ycb_video", "lov") or (
            args.dataset == "synthetic" and args.data_root
            and os.path.exists(os.path.join(args.data_root, "models"))):
        name = "ycb_video" if args.dataset == "synthetic" else args.dataset
        ds = datasets.DATASETS.get(name)(args.data_root, args.image_set)
        cols, nrms = colorize_model_library(ds.points, orient_detail=orient_detail,
                                            paint_version=paint_version)
        return ClassGeometry(ds.num_classes, ds.points, ds.extents, np.asarray(ds.symmetry),
                             cols, nrms, YCB_K, ds=ds)
    if args.dataset != "synthetic":
        raise ValueError(f"unknown --dataset {args.dataset!r}: synthetic, ycb_video, lov or "
                         "linemod")
    t = cfg.train
    proc = make_procedural_objects(t.num_classes, 2620, seed=0)
    k = np.array([[500.0, 0, t.syn_width / 2], [0, 500.0, t.syn_height / 2], [0, 0, 1]],
                 np.float32)
    return ClassGeometry(t.num_classes, proc.points, proc.extents,
                         np.asarray(proc.symmetry, np.float32), proc.colors, proc.normals, k)


def load_backgrounds(pattern, size_hw):
    """The `--backgrounds` pool resized to `size_hw`, or None without a
    pattern."""
    if not pattern:
        return None
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"--backgrounds {pattern!r} matched no files")
    pool = load_background_pool(files, size_hw=size_hw)
    print(f"background compositing pool: {len(pool)} frames")
    return pool


def has_real_frames(ds) -> bool:
    """Whether a dataset reader's image set names frames that are on disk."""
    return ds is not None and len(ds.image_index) > 0 and os.path.exists(
        ds.frame_prefix(ds.image_index[0]) + "-color.png")


def add_dataset_flags(parser: argparse.ArgumentParser, image_set: str) -> None:
    parser.add_argument("--dataset", default="synthetic",
                        help="synthetic (the procedural library, or YCB geometry when "
                        "--data_root holds models/), ycb_video, lov or linemod")
    parser.add_argument("--data_root", default=None,
                        help="the dataset's root (models/, extents.txt, <image_set>.txt, data/)")
    parser.add_argument("--image_set", default=image_set)
    parser.add_argument("--cls", default="",
                        help="LINEMOD object name for --dataset linemod (ape, eggbox, …)")
