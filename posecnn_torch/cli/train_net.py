"""Train PoseCNN on procedural synthetic scenes (PyTorch/CUDA port).

Counterpart of the synthetic `posecnn` branch of
`posecnn_tpu/cli/train_net.py:398-814`:

    python -m posecnn_torch.cli.train_net --cfg experiments/cfgs/lov_color_2d_pool_full.yaml \\
        --iters 200 --output output/train_gpu

    # at toy size on the CPU
    python -m posecnn_torch.cli.train_net --device cpu --iters 2 --output output/toy \\
        --set train.syn_height=96 train.syn_width=128 train.num_classes=4 train.fc_dim=64 \\
        train.num_units=8 train.ims_per_batch=2 train.vertex_reg_2d=True train.pose_reg=True

The class library is the procedural one (`data/procedural.py`, seed 0),
rendered by the carried generator; the feed is `pooled_minibatch` when
`train.syn_pool_size > 0`, produced by two prefetch worker threads. Every
`display` iterations a line goes to stdout and `<output>/metrics.jsonl`;
snapshots in the JAX `.npz` layout go to `<output>` every
`snapshot_iters` and at the end. `--ckpt` resumes as the r6 recipe does:
the parameters and the step are restored, the optimizer starts fresh
(count 0, zero moments) and `train.lr_step_offset` is set to the restored
step. `--reinit` re-randomises named modules after the restore.

Not ported: real-frame datasets (`--dataset`), `--pretrained` (an
ImageNet `vgg16.npy`), `--resume` and the other network families.
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import json
import os
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from posecnn_torch.cli.common import base_parser, load_config, setup_device
from posecnn_torch.core.checkpoint import (
    prune_snapshots,
    restore_params,
    save_params,
    snapshot_path,
)
from posecnn_torch.core.config import Config
from posecnn_torch.data.pipeline import Prefetcher, compact_feed, to_device
from posecnn_torch.data.procedural import load_background_pool, make_procedural_objects
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine.train import TrainState, check_supported, create_train_state, train_loop
from posecnn_torch.models.posecnn import PoseCNN, init_weights

# the JAX package's top-level parameter modules → the port's (for --reinit)
_MODULES = {"VGG16Trunk_0": "trunk", "seg_head": "seg_head", "vertex_head": "vertex_head",
            "pose_head": "pose_head"}


class Trainer(NamedTuple):
    """What `main_run` trains with; `chip_smoke.py` drives the same."""

    cfg: Config
    device: torch.device
    model: PoseCNN
    state: TrainState
    batches: Prefetcher
    points: torch.Tensor  # (C, add_num_points, 3) ADD-loss model points
    extents: torch.Tensor  # (C, 3)
    symmetry: torch.Tensor  # (C,)
    head_meta: dict
    make_batch_factory: Callable  # worker id → a producer of host batches (the feed's)


def _load_backgrounds(pattern, size_hw):
    if not pattern:
        return None
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"--backgrounds {pattern!r} matched no files")
    pool = load_background_pool(files, size_hw=size_hw)
    print(f"background compositing pool: {len(pool)} frames")
    return pool


def build_trainer(args, cfg: Config) -> Trainer:
    """The model, optimizer state, prefetching feed and loss geometry of
    a training run, with `--ckpt` and `--reinit` applied."""
    check_supported(cfg)
    if cfg.train.syn_sample_pose:
        raise ValueError("train.syn_sample_pose=True needs a dataset's pose bank, which the "
                         "port's synthetic training does not read")
    device = setup_device(args.device)
    t = cfg.train
    c = t.num_classes
    proc = make_procedural_objects(c, 2620, seed=0)
    k = np.array([[500.0, 0, t.syn_width / 2], [0, 500.0, t.syn_height / 2], [0, 0, 1]],
                 np.float32)
    idx = np.linspace(0, proc.points.shape[1] - 1, t.add_num_points).astype(int)
    # TRAIN.SCALES_BASE: images, labels, centres and intrinsics scale together
    scale_base = float(t.scales_base[0]) if t.scales_base else 1.0
    train_h, train_w = int(round(t.syn_height * scale_base)), int(round(t.syn_width * scale_base))
    if scale_base != 1.0:
        k = k.copy()
        k[:2, :] *= scale_base
    gen = SyntheticSceneGenerator(
        proc.points, proc.extents, k, width=train_w, height=train_h, t_near=t.syn_tnear,
        t_far=t.syn_tfar, pixel_means=cfg.pixel_means, seed=cfg.rng_seed,
        class_whitelist=[min(t.syn_class_index, c - 1)] if t.syn_class_index > 0 else None,
        sample_object=t.syn_sample_object, point_colors=proc.colors,
        point_normals=proc.normals,
        backgrounds=_load_backgrounds(getattr(args, "backgrounds", None), (train_h, train_w)),
    )

    batch_size = t.ims_per_batch
    model = PoseCNN(
        c, num_units=t.num_units, fc_dim=t.fc_dim, vote_threshold=t.voting_threshold,
        hough_num_samples=t.hough_num_samples, max_objects=max(1, t.max_rois // batch_size // 9),
        hough_backend=t.hough_backend, max_pose_rois=t.max_pose_rois,
        gt_pose_rois=t.gt_pose_rois, pose_pool_size=t.pose_pool_size,
        norm_features=t.norm_features, quat_activation=t.quat_activation,
        # bf16 compute on the card (cfg.compute_dtype); fp32 on the CPU
        compute_dtype=getattr(torch, cfg.compute_dtype) if device.type == "cuda"
        else torch.float32,
    )
    init_weights(model, cfg.rng_seed)
    step0 = 0
    if args.ckpt:
        fresh = {k: v.clone() for k, v in model.state_dict().items()}
        step0 = restore_params(args.ckpt, model)
        for name in (n.strip() for n in (args.reinit or "").split(",")):
            if not name:
                continue
            prefix = _MODULES.get(name, name)
            if prefix not in _MODULES.values():
                raise ValueError(f"--reinit {name!r}: no such module; have {sorted(_MODULES)}")
            model.load_state_dict({k: v for k, v in fresh.items() if k.startswith(prefix + ".")},
                                  strict=False)
            print(f"--reinit: re-randomized '{name}'")
        # a fresh optimizer (count 0) keeps the staircase on the global
        # step through the offset (posecnn_tpu/cli/train_net.py:757-774)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(t, lr_step_offset=step0))
    elif args.reinit:
        raise ValueError("--reinit needs --ckpt")
    model = model.to(device)
    state = create_train_state(cfg, model)
    state.step = step0

    max_gt = 8 * batch_size
    compact = t.compact_feed  # COLOR input, 2D vertex targets (check_supported)

    def make_batch_factory(worker_id):
        g = copy.deepcopy(gen)
        g.rng = np.random.RandomState(cfg.rng_seed + 1000 * (worker_id + 1))

        def make_batch():
            if t.syn_pool_size > 0:
                b = g.pooled_minibatch(batch_size, max_gt=max_gt, dense_vertex_targets=False,
                                       pool_size=t.syn_pool_size, fresh=t.syn_pool_fresh)
            else:
                b = g.minibatch(batch_size, max_gt=max_gt, dense_vertex_targets=False)
            return compact_feed(b, cfg.pixel_means) if compact else b

        return make_batch

    batches = Prefetcher(make_batch_factory=make_batch_factory, queue_size=8, num_workers=2,
                         device_put=lambda b: to_device(b, device))
    head_meta = {
        "norm_features": t.norm_features,
        "quat_activation": t.quat_activation,
        "orient_paint": t.orient_paint,
        "paint_version": t.paint_version,
        "pose_pool_size": t.pose_pool_size,
        "train_scale_base": scale_base,
    }
    return Trainer(
        cfg, device, model, state, batches,
        torch.from_numpy(proc.points[:, idx]).to(device),
        torch.from_numpy(proc.extents).to(device),
        torch.from_numpy(np.asarray(proc.symmetry, np.float32)).to(device),
        head_meta,
        make_batch_factory,
    )


def main_run(args, cfg: Config, max_iters: int) -> TrainState:
    tr = build_trainer(args, cfg)
    cfg = tr.cfg
    os.makedirs(args.output, exist_ok=True)
    log_f = open(os.path.join(args.output, "metrics.jsonl"), "a")

    def log_fn(it_num, metrics):
        metrics["iter"] = it_num
        log_f.write(json.dumps(metrics) + "\n")
        log_f.flush()
        line = ", ".join(f"{k}: {v:.4f}" for k, v in metrics.items() if k != "iter")
        print(f"iter {it_num}/{max_iters} " + line, flush=True)

    def snapshot(it_num):
        path = snapshot_path(args.output, cfg.train.snapshot_prefix, cfg.train.snapshot_infix,
                             it_num)
        save_params(path, tr.model, step=it_num, meta=tr.head_meta)
        prune_snapshots(args.output, cfg.train.snapshot_prefix, cfg.train.snapshot_keep)
        return path

    try:
        state = train_loop(cfg, tr.model, tr.state, tr.batches, tr.points, tr.extents,
                           tr.symmetry, max_iters=max_iters, log_fn=log_fn,
                           snapshot_fn=lambda it, _: print(f"snapshot → {snapshot(it)}"))
    finally:
        tr.batches.close()
        log_f.close()
    # the final snapshot is labelled with the step reached (a resumed run
    # may have started at or beyond max_iters)
    print(f"done → {snapshot(state.step)}")
    return state


def make_parser():
    parser = base_parser("PoseCNN training on synthetic scenes (PyTorch/CUDA)")
    parser.add_argument("--output", default="output/train")
    parser.add_argument("--iters", type=int, default=0, help="override max_iters")
    parser.add_argument("--ckpt", default=None,
                        help="resume from this snapshot (JAX .npz layout): parameters and "
                        "step; the optimizer starts fresh")
    parser.add_argument("--reinit", default=None, metavar="MODULES",
                        help="comma-separated top-level modules (e.g. 'pose_head') to "
                        "re-randomize after the --ckpt restore")
    parser.add_argument("--backgrounds", default=None,
                        help="glob of RGB frames composited behind the renders (default: "
                        "none, uniform noise backgrounds)")
    return parser


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    cfg = load_config(args)
    main_run(args, cfg, args.iters or cfg.train.max_iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
