"""Train PoseCNN on procedural scenes or dataset frames (PyTorch/CUDA port).

Counterpart of the `posecnn` branch of `posecnn_tpu/cli/train_net.py:318-814`:

    python -m posecnn_torch.cli.train_net --cfg experiments/cfgs/lov_color_2d_pool_full.yaml \\
        --iters 200 --output output/train_gpu

    # YCB-Video frames (RGBD, the domain head, the matching loss, … by --cfg)
    python -m posecnn_torch.cli.train_net --dataset lov --data_root /path/to/LOV \\
        --cfg experiments/cfgs/lov_rgbd_2d.yaml --output output/lov_rgbd --resume

    # at toy size on the CPU
    python -m posecnn_torch.cli.train_net --device cpu --iters 2 --output output/toy \\
        --set train.syn_height=96 train.syn_width=128 train.num_classes=4 train.fc_dim=64 \\
        train.num_units=8 train.ims_per_batch=2 train.vertex_reg_2d=True train.pose_reg=True

The class library follows `--dataset` (`cli/common.class_geometry`): the
procedural one (seed 0), YCB-Video's model clouds painted by
`colorize_model_library`, or LINEMOD's `--cls` object (2 classes). Where
the dataset's image set names frames on disk, batches alternate between
the real stream (`get_real_minibatch` over a shuffled index, with
chromatic jitter, noise and mirrored copies per the cfg) and, with
`train.synthesize`, the synthetic one, `1 : train.syn_ratio`, produced in
order by one prefetch thread. Without frames, two prefetch threads render
synthetic batches (`pooled_minibatch` when `train.syn_pool_size > 0`),
each with its own generator. Synthetic batches get the cfg's input mode
from the render's depth (`syn_to_mode`: DEPTH, RGBD's second tower,
NORMAL). Every `display` iterations a line goes to stdout and
`<output>/metrics.jsonl`; snapshots in the JAX `.npz` layout go to
`<output>` every `snapshot_iters` and at the end.

Every family's step is compiled, as the JAX trainers' are jitted
(`engine/train.CompiledTrainStep`, `CompiledDetTrainStep`,
`CompiledSegTrainStep`, `CompiledVideoTrainStep`, `CompiledGanTrainStep`;
no flag): on a card each batch signature's first step runs eagerly and
captures a CUDA graph of the forward, backward and update (the GAN's
both updates, the detection step's RPN NMS on the device scan), which
every later step replays; with `--device cpu` the step runs eagerly. The
data-parallel steps (`--num_data` > 1) run eagerly.

`--ckpt` (or `--resume`, the newest snapshot under `--output`) restores
the parameters before the step is built, and the run resumes in the state
the JAX CLI's does, family by family (`posecnn_tpu/cli/train_net.py`).
The optimizer is always fresh: update count 0, every Adam `step` 0, zero
moments (the discriminator's Adam too). The posecnn family continues the
snapshot's step (iterations, snapshot names, SYMSIZE, dropout streams)
with `train.lr_step_offset` set to it (`:739-775`), so the staircase
follows the global step while Adam's bias-corrected warm-up starts again:
the "restart kick" of the chunked passes (`experiments/train_chunked.sh`).
The detection, segmentation and video families restore the parameters
only: the step, the iterations, the snapshot names and the staircase
start again from 0 (`:146-149`, `:199-202`, `:276-279`). The GAN continues
the step at an offset of 0 (`:713-715`): it applies the staircase at the
pass-local count and logs it at the global step (`engine/train.logged_lr`),
and, like the other families' loops, numbers its iterations and snapshots
from 1 (JAX's `_generic_loop`). `engine/train.fastforward_opt_counts`, the
counterpart of JAX's function, is called by neither CLI.
`--reinit` re-randomises named modules after the restore.

`network: posecnn_det` (`experiments/cfgs/lov_det.yaml` and the LINEMOD
`*_det.yaml`s) trains the detection family instead
(`posecnn_tpu/cli/train_net.py:70-167`): one render a step, its GT boxes
from the label map (8 rows, a box row and its pose row one object),
`PoseCNNDet` with the RPN and RoI targets, the ADD pose term on the class
points, the same optimizer, logging and snapshots:

    python -m posecnn_torch.cli.train_net --cfg experiments/cfgs/lov_det.yaml --iters 200 \
        --output output/det

`network: fcn8` or `resnet50_seg` (the `rgbd_scene_single_*_fcn8.yaml`s;
`--set network=resnet50_seg`) trains a segmentation backbone
(`posecnn_tpu/cli/train_net.py:170-208`): `FCN8` with `train.fc_dim` or
`ResNet50Seg` with `train.num_units`, in `compute_dtype`, on rendered
batches' `data` and `label` with the normalised cross-entropy.
`network: recurrent_seg` (`lov_color_rnn.yaml`, the `*_scene_multi_*`
yamls) trains `RecurrentSegNet` in fp32 (`:211-288`) on
`SyntheticSequenceGenerator` sequences of `train.num_steps` frames, or,
where `--dataset`'s image set names frames on disk, on
`get_real_video_minibatch` sequences from random starts. Both keep the
loop, logging and snapshots above. As in the JAX trainers, their frames
are colour whatever `input` says (a line says so):

    python -m posecnn_torch.cli.train_net --cfg experiments/cfgs/lov_color_rnn.yaml \
        --iters 200 --output output/rnn

The posecnn family's head switches follow the cfg as in the JAX trainer:
`vertex_reg = train.vertex_reg_2d or train.vertex_reg_3d` builds the
vertex head (3D vertex regression trains it as 2D does), `train.pose_reg`
the pose head; seg-only yamls (`rgbd_scene_single_*`, `lov_single_depth`)
and seg + vertex ones (the LINEMOD `*_3d` and 2D yamls, `lov_color_3d`)
train with the terms of their heads only. `train.gan`
(`shapenet_single_single_color_gan.yaml`) trains the PoseCNN as a
generator against a `FeatureDiscriminator` on [255·vertex map ‖ image]
(`engine/train.GanTrainStep`, `posecnn_tpu/cli/train_net.py:697-730`):
`--ckpt` restores the generator, and the snapshots hold the generator's
parameters, as JAX's do. A GAN yaml without a vertex head
(`shapenet_single_color_gan.yaml`) raises: the JAX GAN step fails on it.

`--profile DIR` writes a `torch.profiler` Chrome trace of the whole run
into DIR (`utils/debug.profile_trace`); use it with a small `--iters`.

`--pretrained NPY` starts the posecnn model from a Caffe-layout ImageNet
`vgg16.npy` (`core/checkpoint.import_vgg16_npy`: the 13 convs, fc6 and
fc7; fc8 skipped) before `--ckpt` applies; the GAN, detection,
segmentation and video trainers ignore it, as JAX's do. With `train.max_host_rss_gb` set (the flagship recipe's 100),
the posecnn loop snapshots and exits cleanly once the host's RSS passes
it, for `--resume` to continue.

`--num_data N` trains the posecnn family (and its GAN step) data-parallel
over N ranks (`posecnn_tpu/cli/train_net.py:358,540-550`); the default -1
takes every card, so a machine with one card, or `--device cpu` without
the flag, runs one process as before:

    # every card of the machine, one rank per card over NCCL
    python -m posecnn_torch.cli.train_net --cfg experiments/cfgs/lov_color_2d_pool_full.yaml \
        --num_data -1 --iters 200 --output output/train_dp

    # N processes on the CPU over gloo (any N)
    python -m posecnn_torch.cli.train_net --device cpu --num_data 2 --iters 2 \
        --output output/toy_dp --set train.syn_height=96 train.syn_width=128 ...

The CLI spawns the ranks itself (`parallel/mesh.spawn_ranks`): rank r on
`cuda:r` with NCCL, or on the CPU with gloo, joined through a file
rendezvous under `--output`. More ranks than cards raise JAX's `needs …
devices` error before any CUDA call. The global batch
`train.ims_per_batch` is rounded down to a multiple of N (at least N) and
sizes `max_objects`; each rank renders B/N images (8 GT rows each), its
synthetic workers seeded `rng_seed + 1000·(r·W + w + 1)` for worker w of
W (rank 0 keeps the one-process seeds), its real frames split by
`ShuffledIndexer(process_index=r, process_count=N)` as JAX's hosts split
them, and its synthetic stream beside them seeded `rng_seed + 1000·r`
past rank 0. The ranks compute JAX's global-batch step
(`engine/train.py`); rank 0 alone writes `metrics.jsonl` and the
snapshots, and under `--resume` every rank restores the same newest
snapshot (each looks before its first step, when none can be written). The detection, segmentation and video trainers dispatch before the
mesh in JAX and run one process here too (a line says so).
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import json
import os
import re
import sys
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from posecnn_torch.cli.common import (
    add_dataset_flags,
    base_parser,
    class_geometry,
    has_real_frames,
    load_backgrounds,
    load_config,
    setup_device,
)
from posecnn_torch.core.checkpoint import (
    import_vgg16_npy,
    prune_snapshots,
    restore_params,
    save_params,
    snapshot_path,
)
from posecnn_torch.core.config import Config
from posecnn_torch.core.registry import MODELS
from posecnn_torch.data.minibatch import depth_blob, get_real_minibatch, get_real_video_minibatch
from posecnn_torch.data.pipeline import (
    Prefetcher,
    RatioSampler,
    ShuffledIndexer,
    compact_feed,
    to_device,
)
from posecnn_torch.data.synthetic import SyntheticSceneGenerator, SyntheticSequenceGenerator
from posecnn_torch.engine.train import (
    SEG_FAMILIES,
    GanTrainState,
    TrainState,
    TrainStep,
    check_supported,
    create_train_state,
    discriminator_optimizer,
    make_det_train_step,
    make_gan_train_step,
    make_seg_train_step,
    make_train_step,
    make_video_train_step,
    train_loop,
    vertex_reg,
)
from posecnn_torch.models import PoseCNN, PoseCNNDet
from posecnn_torch.models.gan import FeatureDiscriminator
from posecnn_torch.models.posecnn import init_weights
from posecnn_torch.parallel.mesh import Mesh, create_mesh, spawn_ranks
from posecnn_torch.utils.debug import profile_trace

FEED_WORKERS = 2  # prefetch threads rendering synthetic batches

# the JAX package's top-level parameter modules → the port's (for --reinit)
_MODULES = {"VGG16Trunk_0": "trunk", "seg_head": "seg_head", "vertex_head": "vertex_head",
            "pose_head": "pose_head", "domain_head": "domain_head"}
_DET_MODULES = {name: name for name in ("trunk", "rpn_conv", "rpn_cls_score", "rpn_bbox_pred",
                                        "fc6", "fc7", "cls_score", "bbox_pred", "pose_pred")}


class Trainer(NamedTuple):
    """What `main_run` trains with; `chip_smoke.py` drives the same."""

    cfg: Config
    device: torch.device
    model: torch.nn.Module  # the network family's model (the GAN's generator)
    state: TrainState  # a GanTrainState for the GAN step
    batches: Prefetcher
    points: torch.Tensor  # (C, add_num_points, 3) ADD-loss model points
    extents: torch.Tensor  # (C, 3)
    symmetry: torch.Tensor  # (C,) (the three unused by the seg and video steps)
    head_meta: dict
    make_batch_factory: Callable  # worker id → a producer of host batches (the feed's)
    step: TrainStep  # the family's train step (the posecnn and det ones compiled)


def newest_snapshot(output_dir: str):
    """The `*_iter_N.npz` under `output_dir` with the largest N, or None."""
    pat = re.compile(r"_iter_(\d+)\.npz$")
    snaps = [(int(m.group(1)), p) for p in glob.glob(os.path.join(output_dir, "*_iter_*.npz"))
             if (m := pat.search(p))]
    return max(snaps)[1] if snaps else None


def det_targets(sample, max_gt: int = 8) -> dict:
    """A rendered scene as a detection batch of one image: data (1, H, W, 3)
    and GT boxes from the label map, (max_gt, 5) [x1, y1, x2, y2, cls],
    with their pose rows (max_gt, 13) and valid flags. Box row i and pose
    row i are one object: a class the splat hid entirely has no box, so
    its pose row is dropped too (`posecnn_tpu/cli/train_net.py:103-128`)."""
    gt_boxes = np.zeros((max_gt, 5), np.float32)
    gt_valid = np.zeros(max_gt, bool)
    gt_poses = np.zeros((max_gt, 13), np.float32)
    row = 0
    for pose in sample.poses:
        if row >= max_gt:
            break
        ys, xs = np.nonzero(sample.label == int(pose[1]))
        if len(ys) == 0:
            continue
        gt_boxes[row] = [xs.min(), ys.min(), xs.max(), ys.max(), int(pose[1])]
        gt_poses[row] = pose
        gt_valid[row] = True
        row += 1
    return {"data": sample.image[None], "gt_boxes": gt_boxes, "gt_poses": gt_poses,
            "gt_valid": gt_valid}


def _restore(args, model, modules: dict) -> int:
    """`--ckpt` into `model` with `--reinit`'s modules re-randomised;
    returns the restored step (0 without `--ckpt`)."""
    if not args.ckpt:
        if args.reinit:
            raise ValueError("--reinit needs --ckpt or --resume")
        return 0
    fresh = {k_: v.clone() for k_, v in model.state_dict().items()}
    step0 = restore_params(args.ckpt, model)
    for name in (n.strip() for n in (args.reinit or "").split(",")):
        if not name:
            continue
        prefix = modules.get(name, name)
        if prefix not in modules.values() or getattr(model, prefix, None) is None:
            raise ValueError(f"--reinit {name!r}: no such module; have {sorted(modules)}")
        model.load_state_dict({k_: v for k_, v in fresh.items()
                               if k_.startswith(prefix + ".")}, strict=False)
        print(f"--reinit: re-randomized '{name}'")
    return step0


def _initialised(args, cfg: Config, model, modules: dict, device, pretrained=None, mesh=None):
    """(model, state, cfg): `model` with seeded weights, the `pretrained`
    vgg16.npy and then `--ckpt` / `--reinit` applied, on `device`, a fresh
    optimizer (count 0, zero moments), and the step and cfg of the JAX
    CLI's resume: the posecnn family at the restored step with
    `train.lr_step_offset` set to it, the GAN at the restored step with no
    offset, the other families at step 0 (every rank of a mesh starts from
    the same)."""
    init_weights(model, cfg.rng_seed)
    if pretrained:
        import_vgg16_npy(pretrained, model)
    step0 = _restore(args, model, modules)
    model = model.to(device)
    if cfg.network != "posecnn":
        step0 = 0  # the parameters only
    elif args.ckpt and not cfg.train.gan:
        # the staircase on the global step; Adam's count starts again
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 lr_step_offset=step0))
    state = create_train_state(cfg, model, mesh)
    state.step = step0
    return model, state, cfg


def build_trainer(args, cfg: Config, *, mesh: Optional[Mesh] = None,
                  device: Optional[torch.device] = None) -> Trainer:
    """The model, optimizer state, prefetching feed, loss geometry and
    train step of a training run, with `--ckpt` / `--resume` and
    `--reinit` applied; `network: posecnn_det` gets the detection model
    and step, fcn8 / resnet50_seg the segmentation ones and recurrent_seg
    the video ones. With a data-parallel `mesh` (the posecnn family), this
    rank's trainer on `device` (default `--device`): its share of the
    global batch, its feed seeds, the mesh's step."""
    check_supported(cfg)
    device = setup_device(str(device) if device is not None else args.device)
    rank = mesh.data_index if mesh is not None else 0
    t = cfg.train
    # --pretrained reaches the posecnn trainer only, as in JAX
    pretrained = args.pretrained if cfg.network == "posecnn" and not t.gan else None
    if args.pretrained and pretrained is None:
        print(f"--pretrained: the {cfg.network}{' GAN' if t.gan else ''} trainer loads no "
              "ImageNet weights, as in the JAX trainer")
    if getattr(args, "resume", False) and not args.ckpt:
        args.ckpt = newest_snapshot(args.output)
        print(f"--resume: using {args.ckpt}" if args.ckpt
              else f"--resume: no snapshots under {args.output}, starting fresh")
    geo = class_geometry(args, cfg, bool(t.orient_paint), int(t.paint_version))
    c, ds = geo.num_classes, geo.ds
    idx = np.linspace(0, geo.points.shape[1] - 1, t.add_num_points).astype(int)
    # TRAIN.SCALES_BASE: images, labels, centres and intrinsics scale together
    scale_base = float(t.scales_base[0]) if t.scales_base else 1.0
    train_h, train_w = int(round(t.syn_height * scale_base)), int(round(t.syn_width * scale_base))
    k = geo.k.copy()
    if scale_base != 1.0:
        k[:2, :] *= scale_base
    # SYN_SAMPLE_POSE draws from the dataset's pose bank (<root>/poses/<cls>.txt)
    pose_bank = None
    if t.syn_sample_pose:
        if ds is None:
            raise ValueError("train.syn_sample_pose=True requires --dataset ycb_video|lov (the "
                             "pose bank lives at <root>/poses/<cls>.txt)")
        pose_bank = ds.load_pose_bank()
    gen = SyntheticSceneGenerator(
        geo.points, geo.extents, k, width=train_w, height=train_h, t_near=t.syn_tnear,
        t_far=t.syn_tfar, pixel_means=cfg.pixel_means, seed=cfg.rng_seed,
        class_whitelist=[min(t.syn_class_index, c - 1)] if t.syn_class_index > 0 else None,
        sample_object=t.syn_sample_object, sample_pose=t.syn_sample_pose, pose_bank=pose_bank,
        point_colors=geo.colors, point_normals=geo.normals,
        backgrounds=load_backgrounds(getattr(args, "backgrounds", None), (train_h, train_w)),
    )
    # bf16 compute on the card (cfg.compute_dtype); fp32 on the CPU
    compute_dtype = getattr(torch, cfg.compute_dtype) if device.type == "cuda" else torch.float32
    points = torch.from_numpy(np.ascontiguousarray(geo.points[:, idx])).to(device)
    extents = torch.from_numpy(np.asarray(geo.extents, np.float32)).to(device)
    symmetry = torch.from_numpy(np.asarray(geo.symmetry, np.float32)).to(device)

    def synthetic_factory(produce):
        def make_batch_factory(worker_id):
            g = copy.deepcopy(gen)
            g.rng = np.random.RandomState(
                cfg.rng_seed + 1000 * (rank * FEED_WORKERS + worker_id + 1))
            return lambda: produce(g)

        return make_batch_factory

    # the global batch, rounded to the data axis (JAX's :540-550), sizes
    # max_objects; each rank renders its share
    batch_size = t.ims_per_batch
    if mesh is not None:
        batch_size = max(batch_size, mesh.data_size) // mesh.data_size * mesh.data_size
    local_batch = batch_size // (mesh.data_size if mesh is not None else 1)
    if cfg.network in SEG_FAMILIES + ("recurrent_seg",):
        if cfg.input != "COLOR":
            print(f"input {cfg.input}: the {cfg.network} trainer feeds colour frames, as the "
                  "JAX trainer does")
        return _seg_trainer(args, cfg, device, gen, ds, c, compute_dtype, synthetic_factory,
                            (points, extents, symmetry))
    det = cfg.network == "posecnn_det"
    if det:
        model = PoseCNNDet.from_config(cfg, c, train=True, compute_dtype=compute_dtype)
    else:
        model = PoseCNN(
            c, num_units=t.num_units, fc_dim=t.fc_dim, vote_threshold=t.voting_threshold,
            hough_num_samples=t.hough_num_samples,
            max_objects=max(1, t.max_rois // batch_size // 9),
            hough_backend=t.hough_backend, max_pose_rois=t.max_pose_rois,
            gt_pose_rois=t.gt_pose_rois, pose_pool_size=t.pose_pool_size,
            norm_features=t.norm_features, quat_activation=t.quat_activation,
            adaptation=t.adapt, input_format="RGBD" if cfg.input == "RGBD" else "COLOR",
            vertex_reg=vertex_reg(cfg), pose_reg=t.pose_reg, compute_dtype=compute_dtype,
        )
    model, state, cfg = _initialised(args, cfg, model, _DET_MODULES if det else _MODULES,
                                     device, pretrained, mesh)
    disc = None
    if t.gan:
        # the discriminator scores [255·vertex map ‖ image], in fp32 as the
        # JAX one is built; --ckpt restored the generator only
        disc = FeatureDiscriminator(3 * c + 3)
        init_weights(disc, cfg.rng_seed + 1)
        disc = disc.to(device)
        state = GanTrainState(state.opt, state.step, d_opt=discriminator_optimizer(cfg, disc))

    if det:
        # train_net_det: one rendered image a step, GT boxes from its label
        # map, the ADD pose term on the unscaled class points
        factory = synthetic_factory(lambda g: det_targets(g.render(dense_vertex_targets=False)))
        batches = Prefetcher(make_batch_factory=factory, queue_size=8,
                             num_workers=FEED_WORKERS, device_put=lambda b: to_device(b, device))
        return Trainer(cfg, device, model, state, batches, points, extents, symmetry, {},
                       factory, make_det_train_step(cfg, model, points, symmetry))

    max_gt = 8 * local_batch
    pixel_means = np.asarray(cfg.pixel_means, np.float32)
    # the uint8 feed only where the step never reads depth
    compact = t.compact_feed and cfg.input == "COLOR" and not t.vertex_reg_3d and (
        not t.matching) and not t.gan

    def syn_to_mode(b):
        """The cfg's input mode from the render's metric depth."""
        if cfg.input == "COLOR":
            return compact_feed(b, pixel_means) if compact else b
        blob = np.stack([depth_blob(d, k, cfg.input, pixel_means) for d in b["depth"]])
        b["data_p" if cfg.input == "RGBD" else "data"] = blob.astype(np.float32)
        return b

    def syn_batch(g):
        if t.syn_pool_size > 0:
            return syn_to_mode(g.pooled_minibatch(local_batch, max_gt=max_gt,
                                                  dense_vertex_targets=False,
                                                  pool_size=t.syn_pool_size,
                                                  fresh=t.syn_pool_fresh))
        return syn_to_mode(g.minibatch(local_batch, max_gt=max_gt, dense_vertex_targets=False))

    if has_real_frames(ds):
        # the real and synthetic streams share the sampler, the index and
        # the augmentation draws: one producer, in the JAX feed's order
        indexer = ShuffledIndexer(len(ds.image_index) * (2 if t.use_flipped else 1),
                                  seed=cfg.rng_seed, process_index=rank,
                                  process_count=mesh.data_size if mesh is not None else 1)
        streams = ["real"] + (["syn"] if t.synthesize else [])
        sampler = RatioSampler(streams, [1, t.syn_ratio][: len(streams)])
        data_rng = np.random.RandomState(cfg.rng_seed)
        real_gen = gen
        if rank:  # the ranks' synthetic scenes must differ
            real_gen = copy.deepcopy(gen)
            real_gen.rng = np.random.RandomState(cfg.rng_seed + 1000 * rank)

        def make_real_batch():
            if sampler.next_stream() == "real":
                return get_real_minibatch(
                    ds, indexer.next_batch(local_batch), num_classes=c, height=train_h,
                    width=train_w, pixel_means=pixel_means, input_mode=cfg.input, rng=data_rng,
                    chromatic=t.chromatic, noise=t.add_noise, use_flipped=t.use_flipped,
                    max_gt=max_gt, scale=scale_base, dense_vertex_targets=False)
            return syn_batch(real_gen)

        def make_batch_factory(worker_id):
            if worker_id != 0:
                raise ValueError("the real-frame feed has one producer")
            return make_real_batch

        num_workers = 1
    else:
        make_batch_factory = synthetic_factory(syn_batch)
        num_workers = FEED_WORKERS
    batches = Prefetcher(make_batch_factory=make_batch_factory, queue_size=8,
                         num_workers=num_workers, device_put=lambda b: to_device(b, device))
    if disc is not None:
        # the JAX GAN snapshots record no head metadata
        step = make_gan_train_step(cfg, model, disc, points, extents, symmetry, mesh=mesh)
        return Trainer(cfg, device, model, state, batches, points, extents, symmetry, {},
                       make_batch_factory, step)
    head_meta = {
        "norm_features": t.norm_features,
        "quat_activation": t.quat_activation,
        "orient_paint": t.orient_paint,
        "paint_version": t.paint_version,
        "pose_pool_size": t.pose_pool_size,
        "train_scale_base": scale_base,
    }
    return Trainer(cfg, device, model, state, batches, points, extents, symmetry, head_meta,
                   make_batch_factory,
                   make_train_step(cfg, model, points, extents, symmetry, mesh=mesh))


def _seg_trainer(args, cfg: Config, device, gen, ds, c: int, compute_dtype,
                 synthetic_factory, geometry) -> Trainer:
    """The segmentation (fcn8, resnet50_seg) or video (recurrent_seg)
    trainer (`posecnn_tpu/cli/train_net.py:170-288`)."""
    t = cfg.train
    batch_size = t.ims_per_batch
    if cfg.network == "recurrent_seg":
        # built without compute_dtype in JAX: fp32 on every device
        model = MODELS.get(cfg.network)(c, num_units=t.num_units)
    else:
        width = {"fc_dim": t.fc_dim} if cfg.network == "fcn8" else {"num_units": t.num_units}
        model = MODELS.get(cfg.network)(c, compute_dtype=compute_dtype, **width)
    model, state, cfg = _initialised(args, cfg, model,
                                     {name: name for name, _ in model.named_children()}, device)

    num_workers = FEED_WORKERS
    if cfg.network != "recurrent_seg":
        def seg_batch(g):
            b = g.minibatch(batch_size, dense_vertex_targets=False)
            return {"data": b["data"], "label": b["label"]}

        make_batch_factory = synthetic_factory(seg_batch)
        step = make_seg_train_step(cfg, model)
    elif has_real_frames(ds):
        # real sequences from random starts, one producer in the JAX feed's order
        frame0 = ds.load_frame(ds.image_index[0])
        sb = float(t.scales_base[0]) if t.scales_base else 1.0
        rh, rw = (int(round(n * sb)) for n in frame0["color"].shape[:2])
        pixel_means = np.asarray(cfg.pixel_means, np.float32)
        data_rng = np.random.RandomState(cfg.rng_seed)

        def make_batch_factory(worker_id):
            if worker_id != 0:
                raise ValueError("the real-video feed has one producer")
            return lambda: get_real_video_minibatch(
                ds, data_rng.randint(0, len(ds.image_index), batch_size),
                num_steps=t.num_steps, height=rh, width=rw, pixel_means=pixel_means,
                rng=data_rng, chromatic=t.chromatic, scale=sb)

        num_workers = 1
        step = make_video_train_step(cfg, model)
    else:
        make_batch_factory = synthetic_factory(
            lambda g: SyntheticSequenceGenerator(g, num_steps=t.num_steps).minibatch(batch_size))
        step = make_video_train_step(cfg, model)
    batches = Prefetcher(make_batch_factory=make_batch_factory, queue_size=8,
                         num_workers=num_workers, device_put=lambda b: to_device(b, device))
    return Trainer(cfg, device, model, state, batches, *geometry, {}, make_batch_factory, step)


def main_run(args, cfg: Config, max_iters: int, *, mesh: Optional[Mesh] = None,
             device: Optional[torch.device] = None) -> TrainState:
    """Train and snapshot; with a `mesh`, this rank's part of the run (rank
    0 alone writes the log and the snapshots)."""
    tr = build_trainer(args, cfg, mesh=mesh, device=device)
    cfg = tr.cfg
    chief = mesh is None or mesh.rank == 0
    os.makedirs(args.output, exist_ok=True)
    log_f = open(os.path.join(args.output, "metrics.jsonl"), "a") if chief else None

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
                           snapshot_fn=lambda it, _: print(f"snapshot → {snapshot(it)}"),
                           step=tr.step, mesh=mesh)
    finally:
        tr.batches.close()
        if log_f is not None:
            log_f.close()
    # the final snapshot is labelled with the posecnn step reached (a
    # resumed run may have started at or beyond max_iters), the other
    # families' with max_iters
    if chief:
        print(f"done → {snapshot(state.step if tr.step.continues_numbering else max_iters)}")
    return state


def num_data_ranks(num_data: int, device: str, num_devices: Optional[int] = None) -> int:
    """The data-parallel ranks `--num_data` asks for: on the cards -1 is
    every card (`torch.cuda.device_count()` unless `num_devices` is given;
    no CUDA context is made), and more ranks than cards raise JAX's
    `create_mesh` error; on the CPU any N is N processes, and -1 one."""
    if num_data == 0 or num_data < -1:
        raise ValueError(f"--num_data {num_data}: give a positive count or -1 (every card)")
    if torch.device(device).type != "cuda":
        return max(num_data, 1)
    have = torch.cuda.device_count() if num_devices is None else num_devices
    n = have if num_data == -1 else num_data
    if n > have:
        raise ValueError(f"mesh {n}×1 needs {n} devices, have {have}")
    return max(n, 1)


def _rank_main(rank: int, device: torch.device, args, cfg: Config, max_iters: int,
               num_ranks: int) -> None:
    mesh = create_mesh(num_data=num_ranks)
    if args.profile and rank == 0:
        with profile_trace(args.profile) as path:
            main_run(args, cfg, max_iters, mesh=mesh, device=device)
        print(f"profiler trace of rank 0 → {path}")
        return
    main_run(args, cfg, max_iters, mesh=mesh, device=device)


def launch_data_parallel(args, cfg: Config, max_iters: int, num_ranks: int, *,
                         devices=None, backend: Optional[str] = None) -> None:
    """`main_run` on `num_ranks` spawned ranks (`parallel/mesh.spawn_ranks`):
    by default rank r on `cuda:r` over NCCL, or on the CPU over gloo with
    the host's threads shared out; `devices` and `backend` override the
    map (`chip_smoke.py` puts two ranks on one card over gloo). A rank's
    failure raises here with its traceback. Each rank resolves `--resume`
    in `build_trainer`, before its first all-reduce and so before rank 0
    can write a snapshot: every rank restores the same file."""
    cuda = torch.device(args.device).type == "cuda"
    devices = devices or [f"cuda:{r}" if cuda else "cpu" for r in range(num_ranks)]
    threads = 0 if cuda else max(1, torch.get_num_threads() // num_ranks)
    print(f"--num_data {num_ranks}: {num_ranks} ranks on {', '.join(map(str, devices))}",
          flush=True)
    spawn_ranks(_rank_main, num_ranks, (args, cfg, max_iters, num_ranks), devices=devices,
                backend=backend or ("nccl" if cuda else "gloo"), rendezvous_dir=args.output,
                num_threads=threads)


def make_parser():
    parser = base_parser("PoseCNN training on procedural scenes or dataset frames "
                         "(PyTorch/CUDA)")
    add_dataset_flags(parser, image_set="train")
    parser.add_argument("--output", default="output/train")
    parser.add_argument("--iters", type=int, default=0, help="override max_iters")
    parser.add_argument("--ckpt", default=None,
                        help="resume from this snapshot (JAX .npz layout) as the JAX CLI "
                        "does: the parameters, a fresh optimizer (count 0, zero moments); "
                        "posecnn continues the step with train.lr_step_offset at it, the GAN "
                        "the step, the other families start at step 0")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest snapshot under --output (fresh start "
                        "when there is none)")
    parser.add_argument("--pretrained", default=None, metavar="NPY",
                        help="Caffe-layout ImageNet vgg16.npy to start the posecnn trunk and "
                        "the pose head's fc6/fc7 from (fc8 is skipped); the real ImageNet "
                        "weights are not in this repository")
    parser.add_argument("--reinit", default=None, metavar="MODULES",
                        help="comma-separated top-level modules (e.g. 'pose_head') to "
                        "re-randomize after the --ckpt / --resume restore")
    parser.add_argument("--backgrounds", default=None,
                        help="glob of RGB frames composited behind the renders (default: "
                        "none, uniform noise backgrounds)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler Chrome trace of the whole run into DIR "
                        "(use with a small --iters; rank 0's with --num_data)")
    parser.add_argument("--num_data", type=int, default=-1,
                        help="data-parallel ranks of the posecnn trainer: -1 = every card "
                        "(one process on the CPU), N = N ranks (N processes over gloo "
                        "with --device cpu)")
    return parser


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    cfg = load_config(args)
    if cfg.network != "posecnn":
        num_ranks = 1
        if args.num_data not in (-1, 1):
            print(f"--num_data: the {cfg.network} trainer runs in one process (JAX's "
                  "dispatches before its mesh)")
    else:
        num_ranks = num_data_ranks(args.num_data, args.device)
    if num_ranks > 1:
        os.makedirs(args.output, exist_ok=True)
        launch_data_parallel(args, cfg, args.iters or cfg.train.max_iters, num_ranks)
        return 0
    if args.profile:
        with profile_trace(args.profile) as path:
            main_run(args, cfg, args.iters or cfg.train.max_iters)
        print(f"profiler trace → {path}")
        return 0
    main_run(args, cfg, args.iters or cfg.train.max_iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
