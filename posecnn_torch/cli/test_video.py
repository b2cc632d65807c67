"""Video evaluation: the recurrent segmentation net and TSDF fusion (PyTorch/CUDA port).

Counterpart of `posecnn_tpu/cli/test_video.py` (ref: lib/fcn/test.py:381-555,
the video test loop): for each sequence, the recurrent net's labels with
the flow-warped state, their IoU against the ground truth, the predicted
labels and the depth fused into a TSDF volume (`cfg.test.grid_size`, or
`--grid_size`) at the sequence's camera poses, each frame tracked against
the previous frame's depth, and the labelled surface extracted:

    python -m posecnn_torch.cli.test_video --cfg experiments/cfgs/lov_color_rnn.yaml \\
        --ckpt output/rnn/vgg16_fcn_rnn_lov_iter_200.npz --output output/eval_video

Sequences are `SyntheticSequenceGenerator`'s (seed `--seed`, the procedural
library of `train.num_classes` classes, f = 500 px at
`train.syn_height` × `train.syn_width`), or with `--dataset <registered
name>` `get_real_video_minibatch` sequences of the image set's frames at
their size times `test.scales_base`. The model runs in fp32, as the JAX
CLI builds it. Its forward is compiled (`video_labels` through
`utils/graph.compile_static`, the counterpart of the JAX CLI's
`jax.jit(model.apply)`): on a card one CUDA graph per sequence signature,
its labels fetched before the next call; with `--device cpu` it runs
eagerly. `fuse_frame` and `track_camera` are compiled the same way (JAX
jits both): one graph each a run, the volume made once, bound in place
(`compile_static`'s `inplace`) and cleared in place for each sequence;
`extract_surface` runs eagerly, as in JAX.

Writes `<output>/video_eval.json`: per sequence the mean IoU, the surface
point count and the tracked motion of each frame (metres), the JAX CLI's
keys, plus the seconds of render, forward, fuse, track and extract.
"""

from __future__ import annotations

import json
import os
import time
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from posecnn_torch.cli.common import base_parser, has_real_frames, load_config, setup_device
from posecnn_torch.core.checkpoint import restore_params
from posecnn_torch.core.registry import DATASETS
from posecnn_torch.data.minibatch import get_real_video_minibatch
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator, SyntheticSequenceGenerator
from posecnn_torch.engine.evaluate import fast_hist, iou_from_hist
from posecnn_torch.models.posecnn import init_weights
from posecnn_torch.models.recurrent import RecurrentSegNet
from posecnn_torch.refine.fusion import create_volume, extract_surface, fuse_frame, track_camera
from posecnn_torch.utils.graph import compile_static

STAGES = ("render", "forward", "fuse", "track", "extract")
EYE34 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)


def video_labels(model: RecurrentSegNet, frames: torch.Tensor, depths: torch.Tensor,
                 metas: torch.Tensor) -> torch.Tensor:
    """The recurrent net's labels (T, B, H, W) of a sequence: the program
    `main` compiles."""
    return model(frames, depths, metas)[1]


def make_parser():
    p = base_parser("PoseCNN video evaluation: the recurrent net and TSDF fusion (PyTorch/CUDA)")
    p.add_argument("--num_sequences", type=int, default=2)
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--output", default="output/eval_video")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--seed", type=int, default=77)
    p.add_argument("--dataset", default="synthetic",
                   help="'synthetic' (camera-motion sequences) or a registered dataset name "
                   "(ycb_video, lov, …) whose frames feed get_real_video_minibatch")
    p.add_argument("--data_root", default=None)
    p.add_argument("--image_set", default="val")
    p.add_argument("--grid_size", type=int, default=0,
                   help="TSDF grid side; 0 = cfg.test.grid_size")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    device = setup_device(args.device)
    cfg = load_config(args)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    c = cfg.train.num_classes
    w, h = cfg.train.syn_width, cfg.train.syn_height
    proc = synthetic_class_library(c, 256)
    k = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(proc.points, proc.extents, k, width=w, height=h,
                                  t_near=cfg.train.syn_tnear, t_far=cfg.train.syn_tfar,
                                  pixel_means=cfg.pixel_means, seed=args.seed,
                                  point_colors=proc.colors, point_normals=proc.normals)
    seq_gen = SyntheticSequenceGenerator(gen, num_steps=args.num_steps)

    real_ds = None
    if args.dataset != "synthetic":
        real_ds = DATASETS.get(args.dataset)(args.data_root, args.image_set)
        if not has_real_frames(real_ds):
            raise FileNotFoundError(f"--dataset {args.dataset}: no frames under {args.data_root}")
        c = real_ds.num_classes
        pixel_means = np.asarray(cfg.pixel_means, np.float32)
        frame0 = real_ds.load_frame(real_ds.image_index[0])
        sb = float(cfg.test.scales_base[0]) if cfg.test.scales_base else 1.0
        h, w = (int(round(n * sb)) for n in frame0["color"].shape[:2])
        n_index = len(real_ds.image_index)

        def next_sequence(s):
            return get_real_video_minibatch(real_ds, [(s * args.num_steps) % n_index],
                                            num_steps=args.num_steps, height=h, width=w,
                                            pixel_means=pixel_means, scale=sb)
    else:
        # the JAX CLI draws one sequence to initialise its model: draw it too,
        # so the evaluated sequences are the same
        seq_gen.minibatch(1)

        def next_sequence(s):
            return seq_gen.minibatch(1)

    model = RecurrentSegNet(c, num_units=cfg.train.num_units)
    init_weights(model, cfg.rng_seed)
    if args.ckpt:
        restore_params(args.ckpt, model)
    model = model.to(device).eval()
    forward = compile_static(partial(video_labels, model))
    fuse = compile_static(fuse_frame, inplace=("vol",))
    track = compile_static(track_camera)

    os.makedirs(args.output, exist_ok=True)
    eye = torch.from_numpy(EYE34).to(device)
    gs = args.grid_size or cfg.test.grid_size
    # a fixed physical span (voxels scale inversely with the grid), one
    # volume for the run: the fuse program is bound to its tensors
    vol = create_volume(gs, c, origin=(-0.8, -0.6, 0.3), voxel_size=0.035 * 48.0 / gs,
                        device=device)
    results = []
    for s in range(args.num_sequences):
        sec = dict.fromkeys(STAGES, 0.0)
        t0 = time.perf_counter()
        seq = next_sequence(s)
        if real_ds is not None:
            k = seq["meta"][0, 0, :9].reshape(3, 3).astype(np.float32)  # the frames' own
        sec["render"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        blobs = [torch.from_numpy(np.ascontiguousarray(seq[key])).to(device)
                 for key in ("image", "depth", "meta")]
        with torch.no_grad():
            # the graph's output: read (fetched, fused) before the next call overwrites it
            labels = forward(*blobs)
        labels_pred = labels[:, 0].cpu().numpy()
        sec["forward"] = time.perf_counter() - t0
        gt = seq["label"][:, 0]
        hist = np.zeros((c, c), np.int64)
        for t in range(args.num_steps):
            hist += fast_hist(gt[t].flatten(), labels_pred[t].flatten(), c)
        iou = iou_from_hist(hist)

        # fuse the predicted labels and the depth into the cleared volume,
        # and track each frame against the previous frame's depth
        vol.tsdf.fill_(1.0)
        vol.weight.zero_()
        vol.prob.zero_()
        kt = torch.from_numpy(k).to(device)
        depths = blobs[1][:, 0]
        track_errs = []
        for t in range(args.num_steps):
            t0 = time.perf_counter()
            w2l = EYE34 if t == 0 else seq["meta"][t, 0][18:30].reshape(3, 4).astype(np.float32)
            prob = F.one_hot(labels[t, 0], c).float()
            fuse(vol, depths[t], prob, kt, torch.from_numpy(w2l).to(device))
            sync()
            sec["fuse"] += time.perf_counter() - t0
            if t > 0:
                t0 = time.perf_counter()
                rt = track(depths[t], depths[t - 1], kt, eye, num_iters=6)
                track_errs.append(float(torch.linalg.vector_norm(rt[:, 3])))
                sec["track"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        _, _, valid = extract_surface(vol, max_points=8192)
        n_surface = int(valid.sum())
        sec["extract"] = time.perf_counter() - t0
        results.append({"sequence": s, "mean_iou": float(iou[hist.sum(1) > 0].mean()),
                        "surface_points": n_surface, "tracked_motion_m": track_errs,
                        "seconds": sec})
        print(f"seq {s}: IoU {results[-1]['mean_iou']:.3f}, surface {n_surface} pts")

    with open(os.path.join(args.output, "video_eval.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.output}/video_eval.json")
    return results


if __name__ == "__main__":
    main()
