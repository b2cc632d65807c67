#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (posecnn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and
nvcc. It drives the port's serving path and stops at the first phase
that fails, with a non-zero exit:

  1. the card's name and power limit; build the CUDA vote kernels;
  2. each kernel against its plain PyTorch version at the serve shapes,
     on samples packed from a planted 480×640 scene;
  3. the planted scene through `hough_voting` on the card: the planted
     centres and depths are recovered;
  4. the whole model, small and in fp32, on the card against the CPU;
  5. the HTTP server at full width (22 classes, 480×640, num_units 64,
     fc_dim 4096, 1024 Hough samples, seeded random weights) answering
     POST /infer requests, with the kernel launch counts of that run
     and the request and forward times.

The line before the last is one JSON object with the kernels' results;
the last line is {"ok": true, "device": {...}}. Without a CUDA device,
or without the posecnn_torch package beside it, it prints no result
and exits non-zero.
"""

from __future__ import annotations

import base64
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

HEIGHT, WIDTH, NUM_CLASSES = 480, 640, 22
SAMPLES, MAX_CLASSES = 1024, 8
# (cls, cx, cy, depth, half_w, half_h): three objects, known centres and
# depths. Centres on the 1/8 grid keep the sampled direction field
# symmetric about them, so the vote plateau is centred there too.
PLANTED = [(5, 200.0, 152.0, 0.9, 60, 50), (12, 448.0, 296.0, 1.3, 50, 60),
           (17, 296.0, 400.0, 0.7, 70, 40)]


def planted_scene(height, width, num_classes, objects, factor=8, noise=0.0, seed=0):
    """A label map and the 1/factor-resolution vertex map a perfect
    vertex head would give: per object a box of its class whose unit
    directions (at the low-res pixel centres) point at (cx, cy), with
    log depth. Returns label (H, W) int64 and vertex (H/f, W/f, 3C) fp32."""
    label = np.zeros((height, width), np.int64)
    ys, xs = np.mgrid[0:height, 0:width]
    hl, wl = height // factor, width // factor
    low = (np.random.RandomState(seed).randn(hl, wl, 3 * num_classes) * noise).astype(np.float32)
    ly, lx = np.mgrid[0:hl, 0:wl]
    fy_c, fx_c = (ly + 0.5) * factor - 0.5, (lx + 0.5) * factor - 0.5
    for cls, cx, cy, depth, hw, hh in objects:
        label[(np.abs(xs - cx) <= hw) & (np.abs(ys - cy) <= hh)] = cls
        region = (np.abs(fx_c - cx) <= hw + factor) & (np.abs(fy_c - cy) <= hh + factor)
        dx, dy = cx - fx_c, cy - fy_c
        n = np.sqrt(dx * dx + dy * dy) + 1e-10
        low[region, 3 * cls + 0] += (dx / n)[region]
        low[region, 3 * cls + 1] += (dy / n)[region]
        low[region, 3 * cls + 2] += np.log(depth)
    return label, low


def intrinsics(height, width, f=1066.0):
    k = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], np.float32)
    meta = np.zeros(48, np.float32)
    meta[:9] = k.flatten()
    meta[9:18] = np.linalg.inv(k).flatten()
    return k, meta


def planted_extents(num_classes):
    return np.full((num_classes, 3), 0.15, np.float32) * (np.arange(num_classes) > 0)[:, None]


def packed_planted(device):
    """(K, 8, S) samples and (K, 4) boxes of the planted scene, packed by
    the port's `_prepare_slots` at the serve config."""
    import torch

    from posecnn_torch.ops.hough_voting import _prepare_slots

    label, low = planted_scene(HEIGHT, WIDTH, NUM_CLASSES, PLANTED, noise=0.02)
    _, meta = intrinsics(HEIGHT, WIDTH)
    prep = _prepare_slots(
        torch.from_numpy(label).to(device), torch.from_numpy(low).to(device),
        torch.from_numpy(planted_extents(NUM_CLASSES)).to(device), torch.from_numpy(meta).to(device),
        num_classes=NUM_CLASSES, label_threshold=500, skip_pixels=10, num_samples=SAMPLES,
        max_classes=MAX_CLASSES, vertex_factor=8,
    )
    return prep["packed"], prep["bboxes"]


def cuda_ms(fn, n):
    """Mean device milliseconds of `fn` over n runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def rel_err(got, want):
    """max |got - want| and whether every element is within 1e-5 of want, relatively."""
    import torch

    diff = (got - want).abs()
    ok = bool(torch.all(diff <= 1e-5 * want.abs() + 1e-6))
    return float(diff.max()) if diff.numel() else 0.0, ok


def phase_kernels(device):
    """Kernels against their plain versions at the serve shapes."""
    import torch

    from posecnn_torch.ops import hough_kernels as hk

    samples, bboxes = packed_planted(device)
    k = samples.shape[0]
    coarse = dict(cell_stride=4, grid_h=HEIGHT // 4, grid_w=WIDTH // 4)
    fine = dict(cell_stride=1, grid_h=HEIGHT, grid_w=WIDTH)

    kv, kd = hk.hough_votes_flat(samples, bboxes, **coarse)
    pv, pd = hk.hough_votes_flat_plain(samples, bboxes, **coarse)
    assert kv.shape == (k, (HEIGHT // 4) * (WIDTH // 4)), kv.shape
    assert float(pv.max()) > 0, "the planted scene gave no coarse votes"
    flat_err, ok_v = rel_err(kv, pv)
    _, ok_d = rel_err(kd, pd)
    if not (ok_v and ok_d):
        raise AssertionError(f"flat_vote_kernel disagrees with its plain version: {flat_err}")

    # the window kernel on the origins that the plain coarse votes give
    _, top_i = torch.sort(pv, dim=1, descending=True, stable=True)
    top_i = top_i[:, : hk.TOP_T]
    cw = WIDTH // 4
    oy = ((top_i // cw) * 4 + 2 - hk.WINDOW // 2).clamp(0, HEIGHT - hk.WINDOW)
    ox = ((top_i % cw) * 4 + 2 - hk.WINDOW // 2).clamp(0, WIDTH - hk.WINDOW)
    en = pv.gather(1, top_i) > 0
    origins = torch.stack([oy, ox, en.long()], -1).reshape(k * hk.TOP_T, 3).int().contiguous()
    wv, wd = hk.hough_votes_windows(samples, origins, **fine)
    qv, qd = hk.hough_votes_windows_plain(samples, origins, **fine)
    win_err, ok_v = rel_err(wv, qv)
    _, ok_d = rel_err(wd, qd)
    if not (ok_v and ok_d):
        raise AssertionError(f"window_vote_kernel disagrees with its plain version: {win_err}")

    # the c2f maximum the kernels pick holds the plain maximum's vote
    best_k = hk.hough_votes_c2f(samples, bboxes, **fine)
    best_p = hk.hough_votes_c2f(samples.cpu(), bboxes.cpu(), **fine)
    vk, vp = best_k[0].cpu(), best_p[0]
    if not bool(torch.all((vk - vp).abs() <= 1e-5 * vp.abs())):
        raise AssertionError(f"c2f maximum {vk.tolist()} vs plain {vp.tolist()}")
    same_cell = bool(torch.equal(best_k[2].cpu(), best_p[2]) and torch.equal(best_k[3].cpu(), best_p[3]))

    times = {
        "flat": (cuda_ms(lambda: hk.hough_votes_flat(samples, bboxes, **coarse), 200),
                 cuda_ms(lambda: hk.hough_votes_flat_plain(samples, bboxes, **coarse), 2)),
        "window": (cuda_ms(lambda: hk.hough_votes_windows(samples, origins, **fine), 200),
                   cuda_ms(lambda: hk.hough_votes_windows_plain(samples, origins, **fine), 2)),
    }
    print(f"phase 2 kernels vs plain at serve shapes: flat {tuple(kv.shape)} max_abs_err "
          f"{flat_err:.3g}, windows {tuple(wv.shape)} max_abs_err {win_err:.3g}, c2f maximum "
          f"votes equal, same cell {same_cell}; ms kernel/plain: flat {times['flat'][0]:.4f}/"
          f"{times['flat'][1]:.1f}, window {times['window'][0]:.4f}/{times['window'][1]:.1f}",
          flush=True)
    return {"flat": flat_err, "window": win_err}, times


def phase_planted(device):
    """The planted scene through hough_voting: centres within 1 px, depths 1%."""
    import torch

    from posecnn_torch.ops.hough_voting import hough_voting

    label, low = planted_scene(HEIGHT, WIDTH, NUM_CLASSES, PLANTED, noise=0.02)
    _, meta = intrinsics(HEIGHT, WIDTH)
    out = hough_voting(
        torch.from_numpy(label[None]).to(device), torch.from_numpy(low[None]).to(device),
        torch.from_numpy(planted_extents(NUM_CLASSES)).to(device),
        torch.from_numpy(meta[None]).to(device),
        num_samples=SAMPLES, max_classes=MAX_CLASSES, vertex_factor=8,
    )
    rois, poses, valid = out.rois.cpu().numpy(), out.poses_init.cpu().numpy(), out.valid.cpu().numpy()
    if int(valid.sum()) != len(PLANTED):
        raise AssertionError(f"{int(valid.sum())} valid rows for {len(PLANTED)} planted objects")
    worst_px, worst_depth = 0.0, 0.0
    for cls, cx, cy, depth, _, _ in PLANTED:
        row = np.nonzero(valid & (rois[:, 1] == cls))[0]
        if len(row) != 1:
            raise AssertionError(f"class {cls}: {len(row)} rows")
        r, p = rois[row[0]], poses[row[0]]
        px = max(abs(0.5 * (r[2] + r[4]) - cx), abs(0.5 * (r[3] + r[5]) - cy))
        dz = abs(p[6] - depth) / depth
        if px > 1.0 or dz > 0.01:
            raise AssertionError(f"class {cls}: centre off by {px} px, depth by {dz:.4f}")
        worst_px, worst_depth = max(worst_px, px), max(worst_depth, dz)
    print(f"phase 3 planted scene through hough_voting: {len(PLANTED)} objects, centres within "
          f"{worst_px:.3f} px, depths within {100 * worst_depth:.3f}%", flush=True)


def phase_small_model(device):
    """The whole model, small and in fp32, on the card against the CPU."""
    import torch

    from posecnn_torch.models.posecnn import PoseCNN, init_weights

    c, h, w = 4, 96, 128
    model = PoseCNN(c, num_units=16, fc_dim=64, hough_num_samples=64, max_objects=4)
    init_weights(model, 0)
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.randn(1, h, w, 3).astype(np.float32) * 40.0)
    extents = torch.from_numpy(planted_extents(c))
    _, meta = intrinsics(h, w, f=150.0)
    meta = torch.from_numpy(meta[None])
    ref = model(data, extents, meta)
    got = model.to(device)(data.to(device), extents.to(device), meta.to(device))
    agree = float((got.label_2d.cpu() == ref.label_2d).float().mean())
    if agree < 0.999:
        raise AssertionError(f"label agreement {agree}")
    if agree == 1.0:
        for name in ("rois", "poses_init", "valid"):
            a, b = getattr(got.hough, name).cpu(), getattr(ref.hough, name)
            if not torch.allclose(a.float(), b.float(), atol=1e-3):
                raise AssertionError(f"hough {name} disagrees with the CPU")
        if not torch.allclose(got.poses_pred.cpu(), ref.poses_pred, atol=1e-3):
            raise AssertionError("poses_pred disagrees with the CPU")
    print(f"phase 4 small fp32 model on the card vs the CPU: label agreement {agree:.5f}"
          + (", rois/poses_init/poses_pred within 1e-3" if agree == 1.0 else ""), flush=True)


def phase_serve(card):
    """The HTTP serving path at full width; returns the launch counts of
    the requests."""
    import torch

    from posecnn_torch.cli.serve import build_engine, make_parser, make_server
    from posecnn_torch.ops import hough_kernels as hk

    args = make_parser().parse_args(["--port", "0"])
    t0 = time.perf_counter()
    engine = build_engine(args)
    cfg_line = (f"{engine.num_classes} classes, {engine.height}x{engine.width}, fc_dim "
                f"{engine.model.pose_head.fc6.out_features}, samples "
                f"{engine.model.hough_kw['num_samples']}")
    setup_s = time.perf_counter() - t0
    server = make_server(engine, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    label, _ = planted_scene(HEIGHT, WIDTH, NUM_CLASSES, PLANTED)
    rng = np.random.RandomState(1)
    images = [rng.randint(0, 255, (HEIGHT, WIDTH, 3), np.uint8) for _ in range(4)]
    images.append((label * 11 % 256).astype(np.uint8)[:, :, None].repeat(3, 2))

    def post(img):
        body = json.dumps({"image_b64": base64.b64encode(img.tobytes()).decode(),
                           "shape": list(img.shape)}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/infer", data=body,
                                     headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, out = resp.status, json.loads(resp.read())
        return status, out, (time.perf_counter() - t) * 1000

    try:
        for key in hk.LAUNCHES:
            hk.LAUNCHES[key] = 0
        results = [post(img) for img in images]
        launches = dict(hk.LAUNCHES)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    n_det = 0
    for status, out, _ in results:
        if status != 200 or set(out) != {"detections", "label_shape", "seconds",
                                          "batch_seconds", "batch_size"}:
            raise AssertionError(f"bad response {status}: {str(out)[:200]}")
        for det in out["detections"]:
            vals = det["quat_wxyz"] + det["trans"] + det["roi"] + [det["score"]]
            if not np.all(np.isfinite(vals)):
                raise AssertionError(f"non-finite detection {det}")
            if abs(np.linalg.norm(det["quat_wxyz"]) - 1.0) > 1e-3:
                raise AssertionError(f"quaternion not unit-norm: {det}")
            n_det += 1
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")

    # the device outputs of one forward: finite, valid quaternions unit-norm
    frame = images[-1][: engine.height, : engine.width, ::-1]
    data = torch.from_numpy(frame[None].copy()).to(engine.device)
    meta = torch.from_numpy(engine._meta0).to(engine.device)
    label_2d, rois, poses_init, poses_pred, keep = engine.infer_device(data, meta)
    for name, t in (("rois", rois), ("poses_init", poses_init), ("poses_pred", poses_pred)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name}")
    cls = rois[:, 1].long()
    q = poses_pred.reshape(len(rois), -1, 4)[torch.arange(len(rois)), cls]
    if keep.any() and not bool(((q.norm(dim=1) - 1).abs()[keep] < 1e-3).all()):
        raise AssertionError("valid rows' quaternions are not unit-norm")
    fwd_ms = cuda_ms(lambda: engine.infer_device(data, meta), 20)
    lat = sorted(r[2] for r in results)
    print(f"phase 5 serve over HTTP ({cfg_line}): {len(results)} requests answered, "
          f"{n_det} detections, launches {launches}, engine set-up {setup_s:.1f} s; "
          f"median request {float(np.median(lat)):.2f} ms, forward {fwd_ms:.3f} ms "
          f"(CUDA events, batch 1, after warm-up) on {card}", flush=True)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    try:
        from posecnn_torch.cli.common import setup_device
        from posecnn_torch.ops import _cuda
    except ImportError:
        print("chip_smoke: run it from the repository root (posecnn_torch not found)",
              file=sys.stderr)
        return 2
    device = setup_device("cuda")  # also switches TF32 off: phase 4 compares fp32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _cuda.library()
    print(f"phase 1 card {card}; kernels built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)

    errs, times = phase_kernels(device)
    phase_planted(device)
    phase_small_model(device)
    launches = phase_serve(card)

    names = {"flat": ("flat_vote_kernel", "posecnn_tpu/ops/hough_pallas.py:191"),
             "window": ("window_vote_kernel", "posecnn_tpu/ops/hough_pallas.py:333")}
    print(json.dumps({"kernels": [
        {"name": names[k][0], "route": "cuda", "source": "posecnn_torch/csrc/hough_vote.cu",
         "replaces": names[k][1], "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1]}
        for k in ("flat", "window")
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
