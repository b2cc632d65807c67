"""PoseCNN: the flagship 6D pose estimation network.

Counterpart of `posecnn_tpu/models/posecnn.py:53-382`: the eval forward
the server runs (`forward`) and the training forward (`train_forward`):

  trunk      VGG16 conv1_1..conv5_3; with `input_format="RGBD"` the same
             trunk also runs on the depth blob `data_p` and conv4_3 and
             conv5_3 of the two are concatenated to 1024 channels, which
             the heads and the pose head's fc6 take
  seg head   1×1 score convs on conv4_3/conv5_3, ×2 up of the conv5
             score, sum, 1×1 → C, ×8 up; log-softmax and argmax in fp32
  vertex     the same skip topology with 128 channels, 1×1 → 3C, kept at
             1/8 resolution for Hough (full resolution only on request)
  hough      ops.hough_voting on the argmax labels: single instance, or
             multi-instance with `vote_threshold > 0`
  pose head  dual-scale RoI pool → fc6 → fc7 → fc8 (fp32) → class mask →
             L2 normalise
  adapt      with `adaptation`: gradient reversal (λ 0.01) → fc9 (256) →
             domain_score (2, fp32) on the pooled features

Dtype policy: fp32 parameters; `compute_dtype` (bf16 on the card, fp32
on the CPU) casts each conv's and dense layer's inputs and weights, as
flax's `dtype=` does. Scores are cast to fp32 before the softmax, the
vertex map before Hough, and fc8 runs in fp32.

The head switches are the JAX model's: `vertex_reg` builds the vertex
head and runs Hough, `pose_reg` (with `vertex_reg`) the pose head and,
with `adaptation`, the domain head; the outputs of a head that is not
built are None. Seg only (both off) and seg + vertex (`pose_reg` off) are
the switched yamls' models; 3D vertex regression trains the same vertex
head (`vertex_reg = vertex_reg_2d or vertex_reg_3d`). `train_forward`
runs Hough only for the pose head: with `pose_reg` off the JAX model
computes it and nothing reads it.

Training adds flax-semantics dropout (keep with probability `keep_prob`,
scale by 1/keep_prob) on the two heads' skip sums, after fc6 and fc7 and
after fc9, each drawn from its own `torch.Generator` (five streams, where
`jax.random.split` gives the JAX model four and splits the pose head's in
two), the full-resolution vertex map, the Hough training emission with
optional GT RoIs, and the pose-row compaction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from posecnn_torch.models.vgg16 import VGG16Trunk, bilinear_upsample, conv, nchw, nhwc
from posecnn_torch.ops.gradient_reversal import gradient_reversal
from posecnn_torch.ops.hough_voting import BACKENDS, HoughOutputs, append_gt_rois, hough_voting
from posecnn_torch.ops.roi_align import roi_pool_fused
from posecnn_torch.parallel.mesh import ColumnParallelLinear, Mesh, all_gather, all_reduce_sum


class PoseCNNOutputs(NamedTuple):
    log_prob: torch.Tensor  # (B, H, W, C) log-softmax seg scores
    prob: torch.Tensor  # (B, H, W, C) softmax
    label_2d: torch.Tensor  # (B, H, W) argmax labels
    vertex_pred: Optional[torch.Tensor]  # (B, H, W, 3C), with full_vertex=True
    hough: Optional[HoughOutputs]  # with vertex_reg (in training, with pose_reg too)
    poses_pred: Optional[torch.Tensor]  # (R, 4C) masked unit quaternions, with pose_reg
    poses_tanh: Optional[torch.Tensor]  # (R, 4C) raw fc8 output (after tanh if chosen)
    domain_logits: Optional[torch.Tensor] = None  # (R, 2), with adaptation


def dropout(x: torch.Tensor, keep_prob: float, generator: Optional[torch.Generator]):
    """flax `nn.Dropout` semantics: keep each element with probability
    `keep_prob` (a draw from `generator`), scaled by 1/keep_prob, else 0.
    Identity at keep_prob 1."""
    if keep_prob >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class SkipHead(nn.Module):
    """Two-scale FCN skip head (`posecnn.py:53-94`). NHWC in and out."""

    def __init__(self, in_channels: int, units: int, out_channels: int, *,
                 relu_scores: bool = True, name_prefix: str = "score",
                 return_lowres: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.relu_scores = relu_scores
        self.prefix = name_prefix
        self.return_lowres = return_lowres
        self.compute_dtype = compute_dtype
        self.add_module(f"{name_prefix}_conv5", nn.Conv2d(in_channels, units, 1))
        self.add_module(f"{name_prefix}_conv4", nn.Conv2d(in_channels, units, 1))
        self.add_module(f"{name_prefix}_out", nn.Conv2d(units, out_channels, 1))

    def forward(self, conv4_3: torch.Tensor, conv5_3: torch.Tensor, *, keep_prob: float = 1.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.compute_dtype
        act = F.relu if self.relu_scores else (lambda v: v)
        s5 = act(conv(nchw(conv5_3), getattr(self, f"{self.prefix}_conv5"), dt))
        s5_up = nchw(bilinear_upsample(nhwc(s5), 2))
        s4 = act(conv(nchw(conv4_3), getattr(self, f"{self.prefix}_conv4"), dt))
        # crop to the 1/8 map when H/8 or W/8 is odd (posecnn.py:78)
        added = s4 + s5_up[:, :, : s4.shape[2], : s4.shape[3]]
        added = dropout(added, keep_prob, generator)
        # the 1×1 conv runs before the ×8 upsample (they commute)
        out = nhwc(conv(added, getattr(self, f"{self.prefix}_out"), dt))
        return out if self.return_lowres else bilinear_upsample(out, 8)


def _dense(layer, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A dense layer with its input and weights in `dtype`; a
    column-parallel one (`parallel/mesh.param_sharding`) returns its
    gathered output."""
    if isinstance(layer, ColumnParallelLinear):
        return layer(x, dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class PoseHead(nn.Module):
    """RoI → quaternion regression head (`posecnn.py:97-164`), eval. Under
    tensor parallelism fc6 and fc7 run column-parallel; the dropouts act
    on the gathered activations, with one mask on every model rank."""

    def __init__(self, num_classes: int, in_features: int, fc_dim: int = 4096, *,
                 norm_features: bool = True, quat_activation: str = "linear",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if quat_activation not in ("linear", "tanh"):
            raise ValueError(f"unknown quat_activation {quat_activation!r}")
        self.norm_features = norm_features
        self.quat_activation = quat_activation
        self.compute_dtype = compute_dtype
        self.fc6 = nn.Linear(in_features, fc_dim)
        self.fc7 = nn.Linear(fc_dim, fc_dim)
        self.fc8 = nn.Linear(fc_dim, 4 * num_classes)

    def forward(self, pooled: torch.Tensor, poses_weight: torch.Tensor, *, keep_prob: float = 1.0,
                generators: Sequence[Optional[torch.Generator]] = (None, None)):
        dt = self.compute_dtype
        # NHWC flatten, the order fc6's rows were trained in (posecnn.py:134)
        x = pooled.reshape(pooled.shape[0], -1).float()
        if self.norm_features:
            x = x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-6)
        x = F.relu(_dense(self.fc6, x, dt))
        x = dropout(x, keep_prob, generators[0])
        x = F.relu(_dense(self.fc7, x, dt))
        x = dropout(x, keep_prob, generators[1])
        x = self.fc8(x.float())
        poses_tanh = torch.tanh(x) if self.quat_activation == "tanh" else x
        masked = poses_tanh * poses_weight
        norm = torch.sqrt(torch.sum(masked * masked, dim=1, keepdim=True) + 1e-12)
        return masked / torch.clamp(norm, min=1e-2), poses_tanh


class DomainHead(nn.Module):
    """Domain classifier behind gradient reversal (`posecnn.py:167-181`):
    the flattened pooled features reversed with λ, fc9 (256) with ReLU
    and dropout in the compute dtype, then domain_score (2) in fp32."""

    def __init__(self, in_features: int, lambda_: float = 0.01, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lambda_ = lambda_
        self.compute_dtype = compute_dtype
        self.fc9 = nn.Linear(in_features, 256)
        self.domain_score = nn.Linear(256, 2)

    def forward(self, pooled: torch.Tensor, *, keep_prob: float = 1.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.compute_dtype
        x = gradient_reversal(pooled.reshape(pooled.shape[0], -1), self.lambda_)
        x = F.relu(F.linear(x.to(dt), self.fc9.weight.to(dt), self.fc9.bias.to(dt)))
        x = dropout(x, keep_prob, generator)
        return self.domain_score(x.float())


def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded initialisation in flax's defaults: every conv and dense
    kernel LeCun-normal (truncated at ±2σ, variance 1/fan_in), every
    bias zero, every GroupNorm scale one. A module with a `flax_init`
    method then applies its own initialisers (a zero-initialised gate).
    Draws from a CPU `torch.Generator`; move the model after."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            # 0.8796… is the std of a unit normal truncated at ±2
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.GroupNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
    for mod in model.modules():
        if hasattr(mod, "flax_init"):
            mod.flax_init()


# the JAX package's backend names (`core/config.py` train.hough_backend,
# `PoseCNN.hough_backend`) → the port's; "auto" is c2f on every device
_JAX_BACKENDS = {"auto": "c2f", "pallas_c2f": "c2f", "pallas": "exhaustive", "xla": "dense"}


def resolve_hough_backend(name: str) -> str:
    """The port's Hough backend for a name in the port's terms
    (`ops.hough_voting.BACKENDS`) or the JAX package's
    (auto|xla|pallas|pallas_c2f). Raises on any other name."""
    if name in BACKENDS:
        return name
    if name in _JAX_BACKENDS:
        return _JAX_BACKENDS[name]
    raise ValueError(f"unknown hough backend {name!r}; expected one of "
                     f"{BACKENDS + tuple(_JAX_BACKENDS)}")


def global_pose_row_cap(hough: HoughOutputs, cap: int, num_gt: int, mesh: Mesh) -> HoughOutputs:
    """This data rank's rows of the global batch's `max_pose_rois` cap.
    JAX keeps the first `cap` valid rows of the global emission, which is
    every image's prepended GT rows (`num_gt` of this rank's leading rows),
    then every image's Hough rows, the images in rank order (the GT rows
    too: `make_sharded_device_put` keeps them in the global order). So
    the quota is per block: rank d keeps clamp(cap − the valid GT rows of
    ranks before it, 0, its own) of its valid GT rows, then of its valid
    Hough rows what is left after every rank's GT rows and the earlier
    ranks' Hough rows. The invalid rows the global cap may keep carry no
    weight in any term, so a rank keeps its quota's valid rows alone, in
    emission order; the valid rows kept over all ranks are exactly JAX's."""
    valid = hough.valid
    is_gt = torch.arange(valid.shape[0], device=valid.device) < num_gt
    counts = torch.stack([(valid & is_gt).sum(), (valid & ~is_gt).sum()])
    every = all_gather(counts, mesh.data_group)  # (N, 2)
    before = every[: mesh.data_index].sum(0)
    keep_gt = torch.minimum((cap - before[0]).clamp(min=0), counts[0])
    keep_hough = torch.minimum((cap - every[:, 0].sum() - before[1]).clamp(min=0), counts[1])
    rank_gt = torch.cumsum(valid & is_gt, 0) - 1
    rank_hough = torch.cumsum(valid & ~is_gt, 0) - 1
    keep = valid & torch.where(is_gt, rank_gt < keep_gt, rank_hough < keep_hough)
    rows = torch.nonzero(keep)[:, 0]
    return HoughOutputs(*(a[rows] for a in hough))


def _eval_pose_weight(hough: HoughOutputs, num_classes: int) -> torch.Tensor:
    """Weight mask selecting each RoI's own class quaternion (`posecnn.py:374-382`)."""
    cls = hough.rois[:, 1].long().clamp(0, num_classes - 1)
    return F.one_hot(cls, num_classes).float().repeat_interleave(4, dim=1)


class PoseCNN(nn.Module):
    """The PoseCNN eval forward. Module names follow the JAX parameter
    tree, so `core.weights.params_from_jax` maps a checkpoint onto it."""

    def __init__(self, num_classes: int, num_units: int = 64, fc_dim: int = 4096, *,
                 vote_threshold: float = -1.0, vote_percentage: float = 0.02,
                 skip_pixels: int = 10, hough_num_samples: int = 256, max_objects: int = 16,
                 hough_cell_stride: int = 1, hough_backend: str = "auto",
                 max_pose_rois: int = 0, gt_pose_rois: bool = False,
                 pose_pool_size: int = 7, norm_features: bool = True,
                 quat_activation: str = "linear", adaptation: bool = False,
                 input_format: str = "COLOR", vertex_reg: bool = True, pose_reg: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if input_format not in ("COLOR", "RGBD"):
            raise ValueError(f"input_format {input_format!r}: COLOR (one tower, also for the "
                             "DEPTH and NORMAL blobs) or RGBD (two)")
        self.num_classes = num_classes
        self.input_format = input_format
        # training only: the pose-row budget (0 = off) and the GT RoI
        # prepend (posecnn.py:206-217)
        self.max_pose_rois = max_pose_rois
        self.gt_pose_rois = gt_pose_rois
        # the defaults are the serving configuration: single instance,
        # stride-1 cells, coarse-to-fine votes (posecnn_tpu/cli/serve.py:70-79)
        self.hough_kw = dict(vote_threshold=vote_threshold, vote_percentage=vote_percentage,
                             skip_pixels=skip_pixels, num_samples=hough_num_samples,
                             max_objects_per_image=max_objects, cell_stride=hough_cell_stride,
                             backend=resolve_hough_backend(hough_backend), vertex_factor=8)
        self.pose_pool_size = pose_pool_size
        feat = 1024 if input_format == "RGBD" else 512
        pooled_features = pose_pool_size * pose_pool_size * feat
        self.trunk = VGG16Trunk(compute_dtype=compute_dtype)
        self.seg_head = SkipHead(feat, num_units, num_classes, relu_scores=True,
                                 name_prefix="score", compute_dtype=compute_dtype)
        # the heads the switches build (posecnn.py:284-360); None otherwise
        self.vertex_head = self.pose_head = self.domain_head = None
        if vertex_reg:
            self.vertex_head = SkipHead(feat, 128, 3 * num_classes, relu_scores=False,
                                        name_prefix="vertex", return_lowres=True,
                                        compute_dtype=compute_dtype)
        if vertex_reg and pose_reg:
            self.pose_head = PoseHead(num_classes, pooled_features, fc_dim,
                                      norm_features=norm_features,
                                      quat_activation=quat_activation,
                                      compute_dtype=compute_dtype)
            if adaptation:
                self.domain_head = DomainHead(pooled_features, compute_dtype=compute_dtype)

    def features(self, data: torch.Tensor, data_p: Optional[torch.Tensor] = None):
        """(conv4_3, conv5_3) NHWC of the input, or for RGBD of the colour
        and depth blobs concatenated along channels. The two towers share
        their weights, so they run as one trunk call on the (2B) batch:
        VGG16 has no batch statistics, so each image's features are those
        of a call on it alone."""
        if self.input_format != "RGBD":
            return self.trunk(data)
        if data_p is None:
            raise ValueError("RGBD input_format requires data_p")
        b = data.shape[0]
        conv4_3, conv5_3 = self.trunk(torch.cat([data, data_p]))
        return (torch.cat([conv4_3[:b], conv4_3[b:]], dim=-1),
                torch.cat([conv5_3[:b], conv5_3[b:]], dim=-1))

    @torch.inference_mode()
    def forward(self, data: torch.Tensor, extents: torch.Tensor, meta_data: torch.Tensor, *,
                data_p: Optional[torch.Tensor] = None,
                full_vertex: bool = False) -> PoseCNNOutputs:
        """data: (B, H, W, 3) mean-subtracted BGR (or the DEPTH / NORMAL
        blob); data_p: the RGBD depth blob; extents: (C, 3); meta_data:
        (B, 48). `full_vertex` also returns the ×8-upsampled vertex map,
        which the serving path never reads."""
        conv4_3, conv5_3 = self.features(data, data_p)
        score = self.seg_head(conv4_3, conv5_3).float()
        log_prob = F.log_softmax(score, dim=-1)
        prob = F.softmax(score, dim=-1)
        label_2d = torch.argmax(score, dim=-1)

        vertex_pred = hough = poses_pred = poses_tanh = domain = None
        if self.vertex_head is not None:
            vertex_lr = self.vertex_head(conv4_3, conv5_3).float()
            vertex_pred = bilinear_upsample(vertex_lr, 8) if full_vertex else None
            hough = hough_voting(label_2d, vertex_lr, extents, meta_data, **self.hough_kw)
        if self.pose_head is not None:
            pooled = roi_pool_fused(conv4_3, conv5_3, hough.rois,
                                    pooled_size=self.pose_pool_size)
            poses_pred, poses_tanh = self.pose_head(
                pooled, _eval_pose_weight(hough, self.num_classes)
            )
            domain = self.domain_head(pooled) if self.domain_head is not None else None
        return PoseCNNOutputs(log_prob, prob, label_2d, vertex_pred, hough, poses_pred,
                              poses_tanh, domain)

    def train_forward(self, data: torch.Tensor, extents: torch.Tensor, meta_data: torch.Tensor,
                      gt_poses: torch.Tensor, gt_valid: Optional[torch.Tensor] = None, *,
                      data_p: Optional[torch.Tensor] = None, keep_prob: float = 1.0,
                      generators: Sequence[Optional[torch.Generator]] = (None,) * 5,
                      mesh: Optional[Mesh] = None) -> PoseCNNOutputs:
        """The training forward (`model.apply(..., train=True)`), with
        autograd. gt_poses (G, 13), gt_valid (G,) bool; `generators` are
        the dropout streams of the seg head, the vertex head, fc6, fc7 and
        fc9. The vertex map comes back at full resolution; Hough runs, for
        the pose head only, with no gradient on the detached labels and 1/8
        vertex map. With a `mesh` of several data ranks the inputs are
        this rank's share of the global batch (GT rows renumbered, as
        `data/pipeline.make_sharded_device_put` gives them): the Hough
        rows' domain is the global batch's, and the `max_pose_rois` cap
        keeps this rank's rows of the global cap (`global_pose_row_cap`)."""
        conv4_3, conv5_3 = self.features(data, data_p)
        score = self.seg_head(conv4_3, conv5_3, keep_prob=keep_prob,
                              generator=generators[0]).float()
        log_prob = F.log_softmax(score, dim=-1)
        prob = F.softmax(score, dim=-1)
        label_2d = torch.argmax(score, dim=-1)

        vertex_pred = hough = poses_pred = poses_tanh = domain = None
        if self.vertex_head is not None:
            vertex_lr = self.vertex_head(conv4_3, conv5_3, keep_prob=keep_prob,
                                         generator=generators[1]).float()
            vertex_pred = bilinear_upsample(vertex_lr, 8)
        if self.pose_head is None:
            return PoseCNNOutputs(log_prob, prob, label_2d, vertex_pred, hough, poses_pred,
                                  poses_tanh, domain)
        hough = hough_voting(label_2d, vertex_lr, extents, meta_data, gt_poses, gt_valid,
                             is_train=True, **self.hough_kw)
        data_parallel = mesh is not None and mesh.data_size > 1
        if data_parallel and gt_valid is not None:
            # domain 1 marks a batch without GT: the global batch's
            any_gt = all_reduce_sum(gt_valid.any().float(), mesh.data_group) > 0
            hough = hough._replace(domains=torch.where(any_gt, 0, 1).to(torch.int32).expand(
                hough.domains.shape[0]).contiguous())
        if self.gt_pose_rois:
            hough = append_gt_rois(hough, gt_poses, gt_valid, extents, meta_data,
                                   self.num_classes)
        if data_parallel and self.max_pose_rois > 0:
            num_gt = gt_poses.shape[0] if self.gt_pose_rois else 0
            hough = global_pose_row_cap(hough, self.max_pose_rois, num_gt, mesh)
        elif 0 < self.max_pose_rois < hough.rois.shape[0]:
            # valid rows first; a stable sort keeps the emission order
            # within each group (posecnn.py:328-340)
            order = torch.argsort((~hough.valid).to(torch.uint8), stable=True)
            hough = HoughOutputs(*(a[order[: self.max_pose_rois]] for a in hough))

        pooled = roi_pool_fused(conv4_3, conv5_3, hough.rois, pooled_size=self.pose_pool_size)
        poses_pred, poses_tanh = self.pose_head(pooled, hough.poses_weight, keep_prob=keep_prob,
                                                generators=generators[2:4])
        if self.domain_head is not None:
            domain = self.domain_head(pooled, keep_prob=keep_prob, generator=generators[4])
        return PoseCNNOutputs(log_prob, prob, label_2d, vertex_pred, hough, poses_pred,
                              poses_tanh, domain)
