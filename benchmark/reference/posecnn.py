"""Plain PyTorch reference of the PoseCNN serving forward.

This is the benchmark's yardstick for the `posecnn_ycb` configuration. It
imports nothing of the program under test: every step is written here from
the published description of PoseCNN (Xiang et al., RSS 2018) and the
semantics the serving program documents:

  trunk      VGG16 conv1_1..conv5_3, 3x3 convs with ReLU, 2x2/2 max pools
             after stages 1-4; conv4_3 (1/8) and conv5_3 (1/16)
  seg head   1x1 score convs (ReLU) on conv4_3 and conv5_3, x2 bilinear up
             of the conv5 score, sum, 1x1 conv to C classes, x8 bilinear up;
             the label is the argmax over classes
  vertex     the same skip topology, 128 units, no ReLU, 1x1 conv to 3C,
             kept at 1/8 and read through its x8 bilinear upsample
  hough      single-instance centre voting per present class: up to
             `max_classes` classes with more than `label_threshold` pixels,
             `num_samples` evenly strided pixels each; a cell gets a
             sample's weight where the sample's direction points at it
             within the inlier cone and inside its projected-extent gate;
             the maximum is found coarse to fine (stride-4 coarse grid,
             top-4 coarse cells, 32x32 exact windows around them)
  pose head  RoI-Align (2x2 samples a bin, max) of conv5_3 and conv4_3,
             summed; RMS-normalised; fc6, fc7 (ReLU); fc8; the RoI's class
             quaternion, unit length
  nms        greedy per (image, class) suppression at IoU > threshold with
             the +1 pixel-area convention

Every bilinear resize has half-pixel centres and clamped edges
(`F.interpolate(..., align_corners=False)`).

`precision` selects how the layers that the configuration runs in bfloat16
(every conv, fc6, fc7) compute: "fp32" (TF32 off: the reference itself),
"bf16" (their operands and outputs rounded to bfloat16, as the
configuration states) or "fp8" (operands rounded to float8 e4m3 with one
scale a tensor, accumulated in fp32: the control that `correct` has to
reject). fc8, the softmax, Hough and the pose arithmetic stay fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# (filters, convs) of VGG16's five stages
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
FP8_MAX = 448.0  # the largest finite float8 e4m3fn value
COARSE = 4  # coarse-grid stride of the maximum search, in cells
WINDOW = 32  # exact-window side, in cells
TOP_T = 4  # exact windows a class
INPUT_SCALE = 64.0  # the spread of mean-subtracted 8-bit pixel values
FIRST_CONV = "trunk.conv1_1.weight"


def set_fp32_exact() -> None:
    """TF32 off for matmuls and cuDNN convolutions: fp32 is fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to float8 e4m3 under one per-tensor scale, back in fp32."""
    scale = x.abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale


def _operands(x, w, b, precision):
    if precision == "fp32":
        return x.float(), w.float(), None if b is None else b.float()
    if precision == "bf16":
        return (x.to(torch.bfloat16), w.to(torch.bfloat16),
                None if b is None else b.to(torch.bfloat16))
    if precision == "fp8":
        return _fp8(x), _fp8(w), None if b is None else b.to(torch.bfloat16).float()
    raise ValueError(f"unknown precision {precision!r}: fp32, bf16 or fp8")


def conv(x, w, b, precision, padding=0):
    """NCHW conv in `precision`; returns fp32."""
    xq, wq, bq = _operands(x, w, b, precision)
    return F.conv2d(xq, wq, bq, padding=padding).float()


def linear(x, w, b, precision):
    xq, wq, bq = _operands(x, w, b, precision)
    return F.linear(xq, wq, bq).float()


def upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW bilinear x`factor`, half-pixel centres, clamped edges."""
    return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)


def trunk(weights, x, precision):
    """x: (B, 3, H, W) mean-subtracted BGR. Returns (conv4_3, conv5_3) NCHW."""
    conv4_3 = None
    for stage, (_, n) in enumerate(VGG16_STAGES, start=1):
        for i in range(1, n + 1):
            name = f"trunk.conv{stage}_{i}"
            x = F.relu(conv(x, weights[name + ".weight"], weights[name + ".bias"], precision, 1))
            if precision == "bf16":
                x = x.to(torch.bfloat16).float()
        if stage == 4:
            conv4_3 = x
        if stage < 5:
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
    return conv4_3, x


def skip_head(weights, prefix, conv4_3, conv5_3, precision, relu):
    """The two-scale skip head at 1/8 resolution, NCHW fp32."""
    act = F.relu if relu else (lambda v: v)

    def c(name, x):
        y = conv(x, weights[f"{prefix}_{name}.weight"], weights[f"{prefix}_{name}.bias"],
                 precision)
        return y.to(torch.bfloat16).float() if precision == "bf16" else y

    s5 = act(c("conv5", conv5_3))
    s4 = act(c("conv4", conv4_3))
    added = s4 + upsample(s5, 2)[:, :, : s4.shape[2], : s4.shape[3]]
    return c("out", added)


def features_and_maps(weights, image_bgr, pixel_means, precision):
    """One block of frames. image_bgr: (B, H, W, 3) uint8 BGR on the device.
    Returns (scores (B, H, W, C), vertex (B, H, W, 3C), conv4_3 NHWC,
    conv5_3 NHWC), all fp32; the vertex map is the 1/8 map upsampled x8."""
    x = image_bgr.float() - pixel_means
    conv4_3, conv5_3 = trunk(weights, x.permute(0, 3, 1, 2), precision)
    score = skip_head(weights, "seg_head.score", conv4_3, conv5_3, precision, relu=True)
    vertex = skip_head(weights, "vertex_head.vertex", conv4_3, conv5_3, precision, relu=False)
    scores = upsample(score, 8).permute(0, 2, 3, 1)
    vertex_up = upsample(vertex, 8).permute(0, 2, 3, 1)
    return (scores.contiguous(), vertex_up.contiguous(), conv4_3.permute(0, 2, 3, 1),
            conv5_3.permute(0, 2, 3, 1))


# ---------------------------------------------------------------- Hough


def projected_box_size(ext, fx, fy, distance):
    """max(width, height) in pixels of the projected extent box at a depth."""
    z_near = torch.clamp(distance - ext[..., 2] * 0.5, min=1e-6)
    z_far = torch.clamp(distance + ext[..., 2] * 0.5, min=1e-6)
    max_x = torch.maximum(fx * ext[..., 0] * 0.5 / z_near, fx * ext[..., 0] * 0.5 / z_far)
    max_y = torch.maximum(fy * ext[..., 1] * 0.5 / z_near, fy * ext[..., 1] * 0.5 / z_far)
    return torch.maximum(2 * max_x + 1.0, 2 * max_y + 1.0)


def class_samples(label, vertex_up, extents, k, hough):
    """The voting samples of one frame, from a label map.

    label: (H, W) long; vertex_up: (H, W, 3C) fp32; extents (C, 3); k (3, 3).
    Returns a list of slots (dicts), in class order, of the classes with
    more than `label_threshold` pixels (at most `max_classes`)."""
    num_classes = extents.shape[0]
    flat = label.reshape(-1)
    width = label.shape[1]
    counts = torch.bincount(flat, minlength=num_classes).tolist()
    present = [c for c in range(1, num_classes) if counts[c] > hough["label_threshold"]]
    present = present[: min(hough["max_classes"], num_classes - 1)]
    s = hough["num_samples"]
    fx, fy = float(k[0][0]), float(k[1][1])
    slots = []
    for c in present:
        idx = torch.nonzero(flat == c)[:, 0]
        count = idx.numel()
        j = torch.arange(s, device=label.device)
        pix = idx[(j * count) // s]
        y, x = pix // width, pix % width
        vu = vertex_up[y, x]
        u, v, d = vu[:, 3 * c], vu[:, 3 * c + 1], torch.exp(vu[:, 3 * c + 2])
        slots.append(dict(
            cls=c, count=count, x=x.float(), y=y.float(), u=u, v=v, d=d,
            norm=torch.sqrt(u * u + v * v) + 1e-10,
            w=count / (hough["skip_pixels"] * s),
            thr=0.6 * projected_box_size(extents[c], fx, fy, d),
        ))
    return slots


def votes_at(slot, cx, cy, inlier, chunk=64):
    """Votes and depth sums of one slot at cells (cx, cy) (N,) pixel coords.
    Every sample of a slot weighs the same, so a cell's votes are its count
    of inlier samples times that weight: counted exactly, equal counts tie
    exactly, and more samples always mean more votes."""
    hits = torch.zeros(cx.shape, dtype=torch.float32, device=cx.device)
    dsum = torch.zeros_like(hits)
    n = slot["x"].numel()
    for j0 in range(0, n, chunk):
        sl = slice(j0, j0 + chunk)
        dx = cx[None, :] - slot["x"][sl, None]
        dy = cy[None, :] - slot["y"][sl, None]
        dot = slot["u"][sl, None] * dx + slot["v"][sl, None] * dy
        t2 = ((inlier * slot["norm"][sl]) ** 2)[:, None]
        thr = slot["thr"][sl, None]
        hit = (dot > 0) & (dot * dot > t2 * (dx * dx + dy * dy)) & (dx.abs() < thr) & (
            dy.abs() < thr)
        hits += hit.float().sum(0)
        dsum += torch.where(hit, slot["d"][sl, None], 0.0).sum(0)  # an outlier adds nothing
    return hits * slot["w"], dsum * slot["w"]


def coarse_to_fine_max(slot, height, width, inlier):
    """The slot's vote maximum: the coarse grid at stride COARSE, its TOP_T
    best cells (ties to the lower index), a WINDOW x WINDOW exact window
    around each (clamped into the grid), the first maximum over the windows
    in order. Returns (votes, dsum, x, y) of the best cell."""
    dev = slot["x"].device
    ch, cw = -(-height // COARSE), -(-width // COARSE)
    gy, gx = torch.meshgrid(torch.arange(ch, device=dev), torch.arange(cw, device=dev),
                            indexing="ij")
    cv, _ = votes_at(slot, (gx.reshape(-1) * COARSE).float(), (gy.reshape(-1) * COARSE).float(),
                     inlier)
    top_v, top_i = torch.sort(cv, descending=True, stable=True)
    top_v, top_i = top_v[:TOP_T], top_i[:TOP_T]
    oy = ((top_i // cw) * COARSE + COARSE // 2 - WINDOW // 2).clamp(0, max(height - WINDOW, 0))
    ox = ((top_i % cw) * COARSE + COARSE // 2 - WINDOW // 2).clamp(0, max(width - WINDOW, 0))
    r = torch.arange(WINDOW, device=dev)
    wy = (oy[:, None, None] + r[None, :, None]).expand(TOP_T, WINDOW, WINDOW).reshape(-1)
    wx = (ox[:, None, None] + r[None, None, :]).expand(TOP_T, WINDOW, WINDOW).reshape(-1)
    wv, wd = votes_at(slot, wx.float(), wy.float(), inlier)
    enabled = (top_v > 0).repeat_interleave(WINDOW * WINDOW)
    wv = torch.where(enabled, wv, 0.0)
    wd = torch.where(enabled, wd, 0.0)
    best = int(torch.argmax(wv))
    return float(wv[best]), float(wd[best]), float(wx[best]), float(wy[best])


def box_at(slot, extents, k, x, y, distance, inlier):
    """Half-extents (bb_w, bb_h) of the inlier samples of a slot at a cell,
    full widths as the emission sizes them (negative when none)."""
    dx = x - slot["x"]
    dy = y - slot["y"]
    dist = torch.sqrt(dx * dx + dy * dy) + 1e-10
    cos = (slot["u"] * dx + slot["v"] * dy) / (slot["norm"] * dist)
    thr = 0.6 * projected_box_size(extents[slot["cls"]], float(k[0][0]), float(k[1][1]),
                                   torch.tensor(distance, device=dx.device))
    inl = (cos > inlier) & (dx.abs() < thr) & (dy.abs() < thr)
    bw = 2.0 * float(torch.where(inl, dx.abs(), -1.0).amax())
    bh = 2.0 * float(torch.where(inl, dy.abs(), -1.0).amax())
    return bw, bh


def hough_detections(label, vertex_up, extents, k, hough):
    """Single-instance Hough of one frame: per present class its maximum,
    box and translation. Returns (slots, detections) with detections dicts
    {cls, x, y, votes, distance, trans, roi} for the valid maxima."""
    height, width = label.shape
    inlier = hough["inlier_threshold"]
    slots = class_samples(label, vertex_up, extents, k, hough)
    dets = []
    fx, fy, px, py = float(k[0][0]), float(k[1][1]), float(k[0][2]), float(k[1][2])
    for slot in slots:
        v, dsum, x, y = coarse_to_fine_max(slot, height, width, inlier)
        if v <= 0:
            continue
        distance = dsum / max(v, 1e-10)
        bw, bh = box_at(slot, extents, k, x, y, distance, inlier)
        if bw <= 0 or bh <= 0:
            continue
        dets.append(dict(
            cls=slot["cls"], x=x, y=y, votes=v, distance=distance,
            trans=[(x - px) / fx * distance, (y - py) / fy * distance, distance],
            roi=[x - bw * 0.55, y - bh * 0.55, x + bw * 0.55, y + bh * 0.55],
        ))
    return slots, dets


# ---------------------------------------------------------------- pose head


def roi_align(features, boxes, spatial_scale, pooled=7, samples=2):
    """features (H, W, C) of one frame; boxes (R, 4) xyxy in pixels.
    Returns (R, pooled, pooled, C): the max of each bin's samples x samples
    bilinear taps (positions clipped into the map, minimum RoI size 1)."""
    h, w, c = features.shape
    x1, y1, x2, y2 = (boxes[:, i] * spatial_scale for i in range(4))
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    ii = (torch.arange(pooled * samples, device=boxes.device) + 0.5) / samples
    sx = torch.clamp(x1[:, None] + ii[None] * (rw / pooled)[:, None], 0.0, w - 1.0)
    sy = torch.clamp(y1[:, None] + ii[None] * (rh / pooled)[:, None], 0.0, h - 1.0)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    ax = (sx - x0)[:, None, :, None]
    ay = (sy - y0)[:, :, None, None]
    x0i, y0i = x0.long(), y0.long()
    x1i, y1i = (x0i + 1).clamp(max=w - 1), (y0i + 1).clamp(max=h - 1)

    def tap(yi, xi):
        return features[yi[:, :, None], xi[:, None, :]]

    val = (tap(y0i, x0i) * (1 - ay) * (1 - ax) + tap(y0i, x1i) * (1 - ay) * ax
           + tap(y1i, x0i) * ay * (1 - ax) + tap(y1i, x1i) * ay * ax)
    r = boxes.shape[0]
    return val.reshape(r, pooled, samples, pooled, samples, c).amax(dim=(2, 4))


def pose_quaternions(weights, conv4_3, conv5_3, boxes, classes, precision, pooled=7):
    """Unit quaternions (R, 4) of RoIs of one frame. conv4_3, conv5_3: (h, w, C)
    fp32 NHWC; boxes (R, 4); classes: (R,) long."""
    x = (roi_align(conv5_3, boxes, 1.0 / 16.0, pooled)
         + roi_align(conv4_3, boxes, 1.0 / 8.0, pooled))
    if precision == "bf16":
        x = x.to(torch.bfloat16).float()
    x = x.reshape(x.shape[0], -1)
    x = x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-6)
    x = F.relu(linear(x, weights["pose_head.fc6.weight"], weights["pose_head.fc6.bias"],
                      precision))
    x = F.relu(linear(x, weights["pose_head.fc7.weight"], weights["pose_head.fc7.bias"],
                      precision))
    q8 = F.linear(x, weights["pose_head.fc8.weight"].float(), weights["pose_head.fc8.bias"].float())
    q = q8.reshape(q8.shape[0], -1, 4)[torch.arange(q8.shape[0], device=q8.device), classes]
    return q / torch.clamp(q.norm(dim=1, keepdim=True), min=1e-12)


# ---------------------------------------------------------------- NMS


def box_iou(a, b):
    """IoU of xyxy boxes with the +1 pixel-area convention."""
    iw = max(min(a[2], b[2]) - max(a[0], b[0]) + 1.0, 0.0)
    ih = max(min(a[3], b[3]) - max(a[1], b[1]) + 1.0, 0.0)
    inter = iw * ih
    area_a = (a[2] - a[0] + 1.0) * (a[3] - a[1] + 1.0)
    area_b = (b[2] - b[0] + 1.0) * (b[3] - b[1] + 1.0)
    return inter / max(area_a + area_b - inter, 1e-10)


def nms_per_class(dets, threshold):
    """Greedy descending-score suppression within each class (stable on ties)."""
    order = sorted(range(len(dets)), key=lambda i: -dets[i]["votes"])
    kept = []
    for i in order:
        if all(dets[j]["cls"] != dets[i]["cls"]
               or box_iou(dets[j]["roi"], dets[i]["roi"]) <= threshold for j in kept):
            kept.append(i)
    return [dets[i] for i in kept]


# ---------------------------------------------------------------- the forward


def serve_frames(weights, images_rgb, extents, k, config, precision):
    """The serving forward of a list of RGB frames, a frame at a time.
    Returns per frame (label (H, W) long, detections as the program serves
    them: dicts with "class", "roi", "score", "quat_wxyz", "trans", sorted
    by score)."""
    dev = extents.device
    means = torch.tensor(config["pixel_means"], dtype=torch.float32, device=dev)
    hough = hough_settings(config)
    out = []
    for img in images_rgb:
        bgr = torch.as_tensor(img[:, :, ::-1].copy(), device=dev)[None]
        scores, vertex_up, c4, c5 = features_and_maps(weights, bgr, means, precision)
        label = torch.argmax(scores[0], dim=-1)
        _, dets = hough_detections(label, vertex_up[0], extents, k, hough)
        dets = nms_per_class(dets, config["nms_threshold"])
        if dets:
            boxes = torch.tensor([d["roi"] for d in dets], dtype=torch.float32, device=dev)
            cls = torch.tensor([d["cls"] for d in dets], dtype=torch.long, device=dev)
            quats = pose_quaternions(weights, c4[0], c5[0], boxes, cls, precision,
                                     config["pose_pool_size"]).tolist()
        else:
            quats = []
        served = [{"class": d["cls"], "roi": d["roi"], "score": d["votes"], "quat_wxyz": q,
                   "trans": d["trans"]} for d, q in zip(dets, quats)]
        served.sort(key=lambda d: -d["score"])
        out.append((label, served))
    return out


def hough_settings(config) -> dict:
    return dict(label_threshold=config["label_threshold"], max_classes=config["max_classes"],
                num_samples=config["hough_num_samples"], skip_pixels=config["skip_pixels"],
                inlier_threshold=config["inlier_threshold"])


def param_specs(config):
    """(name, shape, fan_in) of every parameter the serving model holds, in
    the order the weights are drawn."""
    c = config["num_classes"]
    specs = []
    cin = 3
    for stage, (filters, n) in enumerate(VGG16_STAGES, start=1):
        for i in range(1, n + 1):
            specs.append((f"trunk.conv{stage}_{i}.weight", (filters, cin, 3, 3), cin * 9))
            specs.append((f"trunk.conv{stage}_{i}.bias", (filters,), 0))
            cin = filters
    for prefix, units, out in (("seg_head.score", config["num_units"], c),
                               ("vertex_head.vertex", config["vertex_units"], 3 * c)):
        for name, shape in (("conv5", (units, 512, 1, 1)), ("conv4", (units, 512, 1, 1)),
                            ("out", (out, units, 1, 1))):
            specs.append((f"{prefix}_{name}.weight", shape, shape[1]))
            specs.append((f"{prefix}_{name}.bias", shape[:1], 0))
    pooled = config["pose_pool_size"] ** 2 * 512
    for name, shape in (("fc6", (config["fc_dim"], pooled)),
                        ("fc7", (config["fc_dim"], config["fc_dim"])),
                        ("fc8", (4 * c, config["fc_dim"]))):
        specs.append((f"pose_head.{name}.weight", shape, shape[1]))
        specs.append((f"pose_head.{name}.bias", shape[:1], 0))
    return specs


def make_weights(specs, seed: int, device) -> dict:
    """He-scaled normal weights (std sqrt(2 / fan_in)) and zero biases, drawn
    on `device` from `seed` in one call; conv1_1's are further divided by
    INPUT_SCALE, the spread of mean-subtracted 8-bit pixels, so that every
    activation, the vertex head's log depths among them, is of order one.
    Returns name -> fp32 tensor (views into one buffer)."""
    sizes = [math.prod(shape) if fan_in else 0 for _, shape, fan_in in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, fan_in), n in zip(specs, sizes):
        if fan_in:
            scale = math.sqrt(2.0 / fan_in) / (INPUT_SCALE if name == FIRST_CONV else 1.0)
            out[name] = flat[at:at + n].view(shape).mul_(scale)
            at += n
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out
