"""Evaluate PoseCNN on held-out synthetic scenes or dataset frames
(PyTorch/CUDA port).

Counterpart of the posecnn branch of `posecnn_tpu/cli/test_net.py:43-577`.
The class library follows `--dataset` as training's does
(`cli/common.class_geometry`, with the paint recorded in the checkpoint).
Where the dataset's image set names frames on disk (YCB-Video / LOV, and
`test.synthetic` off), the first `--num_images` frames are read with their
GT poses and labels, at 640×480 (times `test.scales_base`), and turned
into the cfg's input blobs by `build_image_blobs` (COLOR, DEPTH, RGBD's
second tower, NORMAL); ICP refines against the frame's depth. Otherwise
frames are rendered by the carried generator from the class library at
the training resolution (seed 1234, held out from training's), with the
input blobs made from the render's depth as training makes them; LINEMOD
is scored so, with its diameters (0.1·d success), reprojection error and
eggbox's 180° z flip. Then the forward with per-class NMS, detections,
optionally RANSAC centres (`--ransac`) and ICP (`--refine`), and
`PoseEvaluator`:

    python -m posecnn_torch.cli.test_net --cfg experiments/cfgs/lov_color_2d_pool_full.yaml \\
        --ckpt output/train/snapshot_iter_N.npz --num_images 64 --refine --output output/eval

    python -m posecnn_torch.cli.test_net --dataset lov --data_root /path/to/LOV \\
        --cfg experiments/cfgs/lov_rgbd_2d.yaml --ckpt output/lov_rgbd/…_iter_N.npz --refine

    # at toy size on the CPU
    python -m posecnn_torch.cli.test_net --device cpu --num_images 2 --refine \\
        --output output/eval_toy --set train.num_classes=4 train.syn_height=48 \\
        train.syn_width=64 train.num_units=16 train.fc_dim=64 test.hough_num_samples=64 \\
        train.add_num_points=32

On the card the posecnn forward with its per-class NMS (the scan on the
device, `nms_scan_kernel`) runs compiled, one CUDA graph per input
signature (RGB, or RGBD with its depth blob), and so does ICP, one graph
per object count, and `--ransac`'s `estimate_center`, one graph at
(1024, 64) (`utils/graph.compile_static`; JAX jits all three); RANSAC's
draw stays on the host. The evaluator's pose errors run compiled too
(`PoseEvaluator`, one graph per padded row count). `--device cpu` runs
every program eagerly.

`<output>/eval.json` holds the evaluator's summary, as the JAX test_net
writes it, and under "run" the device, the images/s of the loop and the
seconds of each stage (render = rendering or reading a frame and making
its blobs, forward = the forward and its NMS, extract = detections and
RANSAC, icp, evaluate), with the number of detections and of refined
ones. The model has every head whatever the training switches said (as
the JAX test_net builds it); its weights come from `--ckpt` (the JAX
`.npz` layout, either package's, of any posecnn-family model: a seg-only
or seg + vertex checkpoint keeps the seeded values of the heads it lacks,
and a line names them, `core/checkpoint.restore_for_eval`), else seeded
random ones (`init_weights`, `rng_seed`).

`network: posecnn_det` evaluates the detection family instead
(`detection_eval`, `posecnn_tpu/cli/test_net.py:423-573`): held-out
renders of the procedural class library (seed `--seed`, f = 500), the
model's proposals and RoI head, softmax scores, un-normalised box deltas
decoded and clipped, one NMS per class at `test.nms_threshold` (all
classes in one call), the 0.05 score threshold, each detection's own
class quaternion and its translation from the box
(`ops/rpn.estimate_translation_from_box`, batched over the frame's
detections), then AP@0.5 (`detection_ap`) and `PoseEvaluator` with
instance matching. JAX jits two programs there, and on the card both run
compiled (`compile_static`): `det_infer` (the forward, scores, decode and
clip, and the per-class NMS on the device scan `ops/nms.greedy_scan`
inside the same graph, up to the detections' mask) as one graph, and
`det_pose` (the quaternions' normalisation and the depth fit) with the
frame's detections padded to the next power of two rows, one graph per
power (the padded rows repeat the last and are dropped); a line prints
the graphs a run captured. The score gate's `torch.nonzero` and the host
lists run between the two, outside any graph, as JAX's loop runs outside
`jit`. It writes `<output>/eval_det.json`: the JAX summary, plus a "run"
block of images/s, stage seconds (render, forward, extract = the
detections, the depth fit and their fetch, evaluate) and the graph
counts.

The segmentation and video families raise here: the JAX `test_net`
has no branch for them and builds a `PoseCNN` whatever `network` says
(`posecnn_tpu/cli/test_net.py:86-100`). `recurrent_seg` is evaluated by
`cli/test_video`.
"""

from __future__ import annotations

import json
import os
import time
from functools import partial

import numpy as np
import torch

from posecnn_torch.cli.common import (
    add_dataset_flags,
    base_parser,
    class_geometry,
    data_flags_from_ckpt,
    forward_with_nms,
    has_real_frames,
    head_flags_from_ckpt,
    load_backgrounds,
    load_config,
    setup_device,
)
from posecnn_torch.core.checkpoint import restore_for_eval, restore_params
from posecnn_torch.data.minibatch import (
    _fit_hw,
    build_image_blobs,
    build_meta_blob,
    depth_blob,
    label_to_boxes,
    mat_to_quat_np,
    resize_bilinear,
    resize_nearest,
)
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine.evaluate import (
    PoseEvaluator,
    detection_ap,
    extract_detections,
    format_per_class_table,
)
from posecnn_torch.engine.train import INPUTS
from posecnn_torch.models.detection import PoseCNNDet
from posecnn_torch.models.posecnn import PoseCNN, init_weights
from posecnn_torch.ops.nms import nms
from posecnn_torch.ops.rpn import estimate_translation_from_box
from posecnn_torch.utils.bbox import bbox_transform_inv, clip_boxes
from posecnn_torch.refine.icp import icp_refine_batch
from posecnn_torch.refine.ransac import draw_hypotheses, estimate_center
from posecnn_torch.utils.graph import compile_static

STAGES = ("render", "forward", "extract", "icp", "evaluate")


def make_parser():
    p = base_parser("PoseCNN evaluation on synthetic scenes or dataset frames (PyTorch/CUDA)")
    add_dataset_flags(p, image_set="val")
    p.add_argument("--ckpt", default=None, help="weights in the JAX .npz layout")
    p.add_argument("--output", default="output/eval")
    p.add_argument("--num_images", type=int, default=20)
    p.add_argument("--refine", action="store_true",
                   help="ICP against the frame's depth (rendered or read)")
    p.add_argument("--ransac", action="store_true",
                   help="translation from a RANSAC centre of the vertex directions instead of "
                   "the Hough maximum")
    p.add_argument("--seed", type=int, default=1234, help="held-out scene seed")
    p.add_argument("--backgrounds", default=None,
                   help="glob of RGB frames composited behind the renders, as training's "
                   "--backgrounds (default: none)")
    p.add_argument("--instance_matching", action="store_true",
                   help="match detections to GTs greedily per instance, not one per class")
    p.add_argument("--save_results", action="store_true",
                   help="write results_NNNN.npz per image (label, rois, keep, poses, classes)")
    return p


def check_supported(cfg) -> None:
    """Raise on a network family this CLI does not evaluate."""
    if cfg.network == "recurrent_seg":
        raise NotImplementedError("network recurrent_seg: evaluate the video family with "
                                  "python -m posecnn_torch.cli.test_video")
    if cfg.network not in ("posecnn", "posecnn_det"):
        raise NotImplementedError(f"network {cfg.network}: test_net evaluates the posecnn and "
                                  "posecnn_det families only (the JAX test_net builds a PoseCNN "
                                  "whatever the network)")
    if cfg.input not in INPUTS:
        raise ValueError(f"input {cfg.input!r}: one of {INPUTS}")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ransac_translation(label, vertex_pred, dets, k, seed, estimate=estimate_center):
    """Each detection's translation from a RANSAC centre of its class's
    vertex directions (up to 1024 pixels, padded to 1024 as JAX pads them,
    64 hypotheses drawn on the host from a generator seeded by (seed,
    detection index)) and the median voted depth. label (H, W) int numpy;
    vertex_pred (H, W, 3C) on the device. `estimate` is `estimate_center`,
    or it compiled (one graph at (1024, 64)); each centre is fetched before
    the next call."""
    n_fix = 1024
    dev = vertex_pred.device
    out = []
    for di, (cls, q, t) in enumerate(dets):
        ys, xs = np.nonzero(label == cls)
        if len(ys) < 10:
            out.append((cls, q, t))
            continue
        sel = np.linspace(0, len(ys) - 1, min(len(ys), n_fix)).astype(int)
        m = len(sel)
        yx = torch.from_numpy(np.stack([ys[sel], xs[sel]])).to(dev)
        vp = vertex_pred[yx[0], yx[1], 3 * cls : 3 * cls + 3]
        px_xy = torch.zeros((n_fix, 2), dtype=torch.float32, device=dev)
        dirs = torch.zeros((n_fix, 2), dtype=torch.float32, device=dev)
        valid = torch.zeros((n_fix,), dtype=torch.bool, device=dev)
        px_xy[:m] = torch.stack([yx[1], yx[0]], 1).float()
        dirs[:m] = vp[:, :2]
        valid[:m] = True
        seq = np.random.SeedSequence([seed, di])
        g = torch.Generator().manual_seed(int(seq.generate_state(1)[0]))
        est = estimate(px_xy, dirs, valid, draw_hypotheses(valid, 64, 2, g, n_valid=m))
        cxy = est.center.cpu().numpy()
        z = float(np.median(torch.exp(vp[:, 2]).cpu().numpy()))
        t_new = np.array([(cxy[0] - k[0, 2]) / k[0, 0] * z, (cxy[1] - k[1, 2]) / k[1, 1] * z, z],
                         np.float32)
        out.append((cls, q, t_new))
    return out


def refine_detections(dets, label_t, depth, points, k, cfg, device, refine):
    """All detections of a frame refined by ICP in one batch, through
    `refine` (`icp_refine_batch` compiled)."""
    cls = torch.tensor([d[0] for d in dets], device=device)
    res = refine(
        torch.from_numpy(np.stack([np.asarray(d[1], np.float32) for d in dets])).to(device),
        torch.from_numpy(np.stack([np.asarray(d[2], np.float32) for d in dets])).to(device),
        points[cls], torch.from_numpy(depth).to(device), label_t[None] == cls[:, None, None],
        torch.from_numpy(k).to(device), num_iters=cfg.test.icp_iters,
        num_hypotheses=cfg.test.icp_hypotheses, rot_perturb=cfg.test.icp_rot_perturb)
    quats, transs = res.quat.cpu().numpy(), res.trans.cpu().numpy()
    return [(c, quats[i], transs[i]) for i, (c, _, _) in enumerate(dets)]


DET_STAGES = ("render", "forward", "extract", "evaluate")
DET_SCORE_THRESH = 0.05


def det_infer(model, data, *, means, stds, bbox_reg: bool, nms_threshold: float):
    """The detection forward as JAX's `infer` (`posecnn_tpu/cli/test_net.py:478-490`):
    the model on data (1, H, W, 3), the softmax scores (R, C), the box
    deltas un-normalised by `means` and `stds` (None: as trained, raw)
    and decoded (`bbox_reg`) or the proposals, clipped to the image,
    (R, C, 4); then one NMS per foreground class on the device scan, and
    the detections' mask hit (C-1, R): kept, scored above
    DET_SCORE_THRESH and a valid proposal. Returns (scores, boxes, tanh
    quaternions (R, 4C), hit)."""
    c = model.num_classes
    height, width = data.shape[1], data.shape[2]
    out = model(data)
    scores = torch.softmax(out.cls_logits, dim=-1)
    deltas = out.bbox_pred * stds + means if means is not None else out.bbox_pred
    rois = out.proposals.rois[:, 1:5]
    boxes = bbox_transform_inv(rois, deltas) if bbox_reg else rois.repeat(1, c)
    boxes = clip_boxes(boxes, height, width).reshape(-1, c, 4)
    valid = out.proposals.valid
    keep = nms(boxes[:, 1:].transpose(0, 1), scores[:, 1:].t(), nms_threshold, valid=valid)
    hit = keep & (scores[:, 1:].t() > DET_SCORE_THRESH) & valid
    return scores, boxes, out.poses_pred, hit


def det_pose(quats, boxes, points, k):
    """JAX's `det_pose` (`posecnn_tpu/cli/test_net.py:497-501`) batched
    over detections: each tanh quaternion (N, 4) normalised, and its
    translation from its box (N, 4) and class points (N, P, 3)
    (`ops/rpn.estimate_translation_from_box`). Returns (quats, trans)."""
    q = quats / torch.clamp(torch.linalg.vector_norm(quats, dim=1, keepdim=True), min=1e-12)
    return q, estimate_translation_from_box(q, boxes, points, k)


def padded_rows(n: int) -> int:
    """The row count `det_pose` runs at for n detections: the next power of
    two, so that a run captures one graph per power and not per count."""
    return 1 << max(n - 1, 0).bit_length()


def detection_eval(args, cfg, device) -> dict:
    """The detection family's evaluation (see the module's docstring);
    returns what it writes to eval_det.json."""
    c = cfg.train.num_classes
    width, height = cfg.train.syn_width, cfg.train.syn_height
    proc = synthetic_class_library(c, 256)
    k = np.array([[500.0, 0, width / 2], [0, 500.0, height / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(proc.points, proc.extents, k, width=width, height=height,
                                  t_near=cfg.train.syn_tnear, t_far=cfg.train.syn_tfar,
                                  pixel_means=cfg.pixel_means, seed=args.seed,
                                  point_colors=proc.colors, point_normals=proc.normals)
    model = PoseCNNDet.from_config(
        cfg, c, train=False,
        compute_dtype=getattr(torch, cfg.compute_dtype) if device.type == "cuda"
        else torch.float32)
    if args.ckpt:
        print(f"restored checkpoint at step {restore_params(args.ckpt, model)}")
    else:
        init_weights(model, cfg.rng_seed)
    model = model.to(device).eval()
    # trained deltas are standardised (BBOX_NORMALIZE_TARGETS_PRECOMPUTED)
    means = stds = None
    if cfg.train.bbox_normalize_targets:
        means = torch.tensor(np.tile(np.asarray(cfg.train.bbox_normalize_means, np.float32), c),
                             device=device)
        stds = torch.tensor(np.tile(np.asarray(cfg.train.bbox_normalize_stds, np.float32), c),
                            device=device)
    points_sub = torch.from_numpy(np.ascontiguousarray(
        proc.points[:, :: max(1, proc.points.shape[1] // 256)])).to(device)
    k_t = torch.from_numpy(k).to(device)
    # the two programs JAX jits, each one CUDA graph per input signature on
    # the card: infer one, det_pose one per padded detection count
    infer = compile_static(partial(det_infer, model, means=means, stds=stds,
                                   bbox_reg=cfg.test.bbox_reg,
                                   nms_threshold=cfg.test.nms_threshold))
    pose = compile_static(det_pose)
    pose_eval = PoseEvaluator(num_classes=c, points=proc.points, extents=proc.extents,
                              instance_matching=True, device=str(device))
    all_dets, all_gts, pose_errs = [], [], []
    seconds = dict.fromkeys(DET_STAGES, 0.0)
    n_dets = 0
    wall0 = time.perf_counter()
    for _ in range(args.num_images):
        t = [time.perf_counter()]
        sample = gen.render()
        t.append(time.perf_counter())
        with torch.no_grad():
            scores, boxes, poses_tanh, hit = infer(torch.from_numpy(sample.image[None]).to(device))
        _sync(device)
        t.append(time.perf_counter())
        with torch.no_grad():
            # the score gate's count depends on the data: on the host, as in JAX
            cls_i, roi_i = (x.cpu() for x in torch.nonzero(hit, as_tuple=True))  # class-major
            cls_i = cls_i + 1
            n = len(cls_i)
            det_boxes = boxes[roi_i, cls_i]  # (N, 4)
            det_scores = scores[roi_i, cls_i].cpu().numpy()
            q, trans = np.zeros((0, 4), np.float32), np.zeros((0, 3), np.float32)
            if n:
                rows = torch.arange(padded_rows(n)).clamp(max=n - 1)  # padding repeats row n-1
                q, trans = pose(poses_tanh.reshape(-1, c, 4)[roi_i, cls_i][rows],
                                det_boxes[rows], points_sub[cls_i[rows]], k_t)
                q, trans = q[:n].cpu().numpy(), trans[:n].cpu().numpy()
            det_boxes = det_boxes.cpu().numpy()
        dets = [(int(cls), float(det_scores[j]), tuple(det_boxes[j]), q[j], trans[j])
                for j, cls in enumerate(cls_i.tolist())]
        n_dets += len(dets)
        t.append(time.perf_counter())
        # translation error of each detection against the first GT of its class
        for cls, _, _, _, t_i in dets:
            for pose_row in sample.poses:
                if int(pose_row[1]) == cls:
                    pose_errs.append(float(np.linalg.norm(t_i - pose_row[10:13])))
                    break
        pose_eval.add_image([(cls, q_i, t_i) for cls, _, _, q_i, t_i in dets],
                            [(int(p[1]), p[6:10], p[10:13]) for p in sample.poses])
        all_dets.append([d[:3] for d in dets])
        gt_boxes = label_to_boxes(sample.label, sample.poses[:, 1].astype(np.int64))
        all_gts.append([(int(b[4]), tuple(b[:4])) for b in gt_boxes])
        t.append(time.perf_counter())
        for name, a, b in zip(DET_STAGES, t, t[1:]):
            seconds[name] += b - a
    wall = time.perf_counter() - wall0
    graphs = {"det_infer": len(infer.programs), "det_pose": len(pose.programs)}
    if device.type == "cuda":
        print(f"compiled programs: det_infer {graphs['det_infer']} CUDA graph(s), det_pose "
              f"{graphs['det_pose']} (at "
              f"{sorted(p.args[0].shape[0] for p in pose.programs.values())} rows)")

    result = detection_ap(all_dets, all_gts, c, iou_threshold=0.5)
    result["mean_trans_err_m"] = float(np.mean(pose_errs)) if pose_errs else None
    result["pose"] = {k_: v for k_, v in pose_eval.summarize().items()
                      if k_ in ("add_auc", "adds_auc", "per_class")}
    result["run"] = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "images_per_s": args.num_images / wall if args.num_images else 0.0,
        "seconds": seconds, "detections": n_dets, "graphs": graphs,
    }
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "eval_det.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({"map@0.5": result["map"], "classes": len(result["per_class"])}))
    print(f"wrote {args.output}/eval_det.json")
    return result


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    cfg = load_config(args)
    check_supported(cfg)
    device = setup_device(args.device)
    if cfg.network == "posecnn_det":
        return detection_eval(args, cfg, device)
    geo = class_geometry(args, cfg, **data_flags_from_ckpt(cfg, args.ckpt))
    c, ds, k = geo.num_classes, geo.ds, geo.k
    width, height = cfg.train.syn_width, cfg.train.syn_height
    diameters = intrinsics = None
    z_flip = ()
    if geo.linemod is not None:
        lm, ci = geo.linemod, geo.linemod_index
        adi_classes = (1,) if lm.symmetry[ci] > 0 else ()
        intrinsics = k
        diameters = np.asarray([0.0, lm.diameters[ci]], np.float32)
        z_flip = (1,) if ci in lm.z_flip_classes else ()
    elif ds is not None:
        adi_classes = ds.adi_classes
    else:
        adi_classes = tuple(int(i) for i in np.nonzero(geo.symmetry)[0])
    # TEST.SYNTHETIC scores rendered frames even where real ones exist
    real = not cfg.test.synthetic and has_real_frames(ds)
    if real:
        width, height = 640, 480
    # TEST.SCALES_BASE: evaluate at a rescaled resolution, intrinsics with it
    scale_base = float(cfg.test.scales_base[0]) if cfg.test.scales_base else 1.0
    k_unscaled = k
    if scale_base != 1.0:
        width, height = int(round(width * scale_base)), int(round(height * scale_base))
        k = k.copy()
        k[:2, :] *= scale_base
    gen = SyntheticSceneGenerator(
        geo.points, geo.extents, k, width=width, height=height, t_near=cfg.train.syn_tnear,
        t_far=cfg.train.syn_tfar, pixel_means=cfg.pixel_means, seed=args.seed,
        point_colors=geo.colors, point_normals=geo.normals,
        backgrounds=load_backgrounds(args.backgrounds, (height, width)),
    )
    idxp = np.linspace(0, geo.points.shape[1] - 1, cfg.train.add_num_points).astype(int)
    points = geo.points[:, idxp]

    model = PoseCNN(
        c, num_units=cfg.train.num_units, fc_dim=cfg.train.fc_dim,
        **head_flags_from_ckpt(cfg, args.ckpt),
        # bf16 compute on the card (cfg.compute_dtype); fp32 on the CPU
        compute_dtype=getattr(torch, cfg.compute_dtype) if device.type == "cuda"
        else torch.float32,
        hough_num_samples=cfg.test.hough_num_samples, skip_pixels=cfg.test.hough_skip_pixels,
        max_objects=8, vote_threshold=cfg.test.voting_threshold,
        # a checkpoint trained with the domain head carries its parameters
        adaptation=cfg.train.adapt, input_format="RGBD" if cfg.input == "RGBD" else "COLOR",
    )
    # every head, whatever the training switches: a checkpoint of a
    # switched model keeps the seeded values of the heads it lacks, as the
    # JAX test_net keeps its template (posecnn_tpu/cli/test_net.py:194-216)
    init_weights(model, cfg.rng_seed)
    if args.ckpt:
        print(f"restored checkpoint at step {restore_for_eval(args.ckpt, model)}")
    model = model.to(device).eval()
    extents_t = torch.from_numpy(np.asarray(geo.extents, np.float32)).to(device)
    points_t = torch.from_numpy(np.ascontiguousarray(points)).to(device)
    meta0 = np.zeros(48, np.float32)
    meta0[:9] = k.flatten()
    meta0[9:18] = np.linalg.inv(k).flatten()
    pm = np.asarray(cfg.pixel_means, np.float32)
    # the forward with its NMS, and ICP, each one CUDA graph per input
    # signature on the card; outputs live until their next call
    forward = compile_static(partial(forward_with_nms, model,
                                     nms_threshold=cfg.test.nms_threshold))
    refine = compile_static(icp_refine_batch)
    center = compile_static(estimate_center)

    def rendered_frame():
        sample = gen.render()
        gts = [(int(row[1]), row[6:10], row[10:13]) for row in sample.poses]
        blob, blob_p = sample.image, None
        if cfg.input == "RGBD":
            blob_p = depth_blob(sample.depth, k, "DEPTH", pm).astype(np.float32)
        elif cfg.input in ("DEPTH", "NORMAL"):
            blob = depth_blob(sample.depth, k, cfg.input, pm).astype(np.float32)
        return blob, blob_p, meta0, sample.depth, sample.label, gts

    def read_frame(index):
        frame = ds.load_frame(index)
        kf = np.array(frame.get("intrinsic_matrix", k_unscaled), np.float32)
        color = frame["color"][..., :3]
        depth_raw = frame.get("depth_raw")
        if scale_base != 1.0:
            color = resize_bilinear(color, scale_base).astype(color.dtype)
            if depth_raw is not None:
                depth_raw = resize_nearest(depth_raw, scale_base)
            kf = kf.copy()
            kf[:2, :] *= scale_base
        color = _fit_hw(color, height, width)
        if depth_raw is not None:
            depth_raw = _fit_hw(depth_raw.astype(np.float32), height, width)
        factor = float(np.squeeze(frame["meta"].get("factor_depth", 1000.0))) if (
            "meta" in frame) else 1000.0
        blob, blob_p = build_image_blobs(color, depth_raw, kf, input_mode=cfg.input,
                                         pixel_means=pm, depth_factor=factor)
        poses = frame.get("poses")
        gts = []
        if poses is not None:
            if poses.ndim == 2:
                poses = poses[:, :, None]
            for j, cls in enumerate(frame.get("cls_indexes", [])):
                gts.append((int(cls), mat_to_quat_np(poses[:, :3, j]), poses[:, 3, j]))
        gt_label = frame.get("label")
        if gt_label is not None:
            if scale_base != 1.0:
                gt_label = resize_nearest(np.asarray(gt_label), scale_base)
            gt_label = _fit_hw(gt_label, height, width)
        depth_m = depth_raw / factor if depth_raw is not None else None
        return blob, blob_p, build_meta_blob(kf), depth_m, gt_label, gts

    if real:
        frames = (lambda index=index: read_frame(index)
                  for index in ds.image_index[: args.num_images])
    else:
        frames = (rendered_frame for _ in range(args.num_images))

    use_ransac = args.ransac or cfg.test.ransac
    evaluator = PoseEvaluator(num_classes=c, points=points, extents=geo.extents,
                              symmetric_classes=tuple(adi_classes),
                              instance_matching=args.instance_matching, diameters=diameters,
                              z_flip_classes=z_flip, intrinsics=intrinsics, device=str(device))
    seconds = dict.fromkeys(STAGES, 0.0)
    n_images = n_dets = n_refined = 0
    os.makedirs(args.output, exist_ok=True)
    wall0 = time.perf_counter()
    for i, make_frame in enumerate(frames):
        t = [time.perf_counter()]
        blob, blob_p, meta, depth, gt_label, gts = make_frame()
        kk = meta[:9].reshape(3, 3)
        t.append(time.perf_counter())
        out, keep = forward(
            torch.from_numpy(blob[None]).to(device), extents_t,
            torch.from_numpy(meta[None]).to(device),
            data_p=None if blob_p is None else torch.from_numpy(blob_p[None]).to(device),
            full_vertex=use_ransac)
        _sync(device)
        t.append(time.perf_counter())
        label_t = out.label_2d[0]
        label = label_t.cpu().numpy()
        rois = out.hough.rois.cpu().numpy()
        dets = extract_detections(rois, out.hough.poses_init.cpu().numpy(),
                                  out.poses_pred.cpu().numpy(), keep.cpu().numpy(), c)
        if use_ransac and dets:
            dets = ransac_translation(label, out.vertex_pred[0], dets, kk, args.seed, center)
        if args.save_results:
            np.savez_compressed(
                os.path.join(args.output, f"results_{i:04d}.npz"),
                label=label.astype(np.int32), rois=rois, keep=keep.cpu().numpy(),
                poses=np.asarray([np.concatenate([q, t_]) for _, q, t_ in dets])
                if dets else np.zeros((0, 7), np.float32),
                classes=np.asarray([cls for cls, _, _ in dets], np.int32),
            )
        n_dets += len(dets)
        t.append(time.perf_counter())
        if args.refine and dets and depth is not None:
            dets = refine_detections(dets, label_t, np.asarray(depth, np.float32), points_t, kk,
                                     cfg, device, refine)
            n_refined += len(dets)
        t.append(time.perf_counter())
        if gt_label is not None:
            evaluator.add_segmentation(gt_label, label)
        evaluator.add_image(dets, gts)
        t.append(time.perf_counter())
        for name, a, b in zip(STAGES, t, t[1:]):
            seconds[name] += b - a
        n_images += 1
    wall = time.perf_counter() - wall0

    summary = evaluator.summarize()
    summary["run"] = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "images_per_s": n_images / wall if n_images else 0.0,
        "seconds": seconds, "detections": n_dets, "refined": n_refined,
    }
    with open(os.path.join(args.output, "eval.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(format_per_class_table(summary, list(ds.classes) if ds is not None else None))
    print(json.dumps({k_: v for k_, v in summary.items() if k_ != "per_class"}, indent=2))
    print(f"wrote {args.output}/eval.json")
    return summary


if __name__ == "__main__":
    main()
