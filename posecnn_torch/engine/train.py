"""Training engine: loss assembly, optimizer, train steps and loop.

Counterpart of `posecnn_tpu/engine/train.py:49-462` for the posecnn
family and of `make_det_train_step` (`:647`) for the detection family.
Loss composition as in the reference's train_net:

  loss = loss_cls
       + VERTEX_W · smooth_l1_vertex
       + POSE_W · average_distance_loss
       + QMAG_W · (|q_raw| − 1)² on the weighted rows
       [+ matching loss]               (train.matching)
       [+ ADAPT_WEIGHT · domain CE]    (train.adapt)
       + WEIGHT_REG · L2(kernels)      (added to the gradient by the optimizer)

The optimizer is optax's chain in the same order and with the same
formulas, so that a step here moves the parameters as the JAX step does:
masked `add_decayed_weights` and `clip_by_global_norm` as
`torch._foreach_*` ops over all gradients, then optax's momentum trace
(`_foreach` ops) or `torch.optim.Adam`, on the staircase `lr_schedule`.
The learning rate the update reads is a device tensor (Adam's on the
CPU: a float), which the host sets before each update.

A step is forward with autograd, `backward()`, update. Hough inside the
forward runs without gradient (its kernels have no backward and need
none). Dropout streams come from (seed, step), as
`jax.random.fold_in(PRNGKey(seed), step)` gives the JAX step its key.
The inputs are COLOR, DEPTH or NORMAL blobs in `data`, or RGBD's colour
in `data` and depth in `data_p`. `TrainStep` runs eagerly, one launch at
a time (`eager`). Every family's `make_*_train_step` gives its compiled
step, the counterpart of its JAX step's `jax.jit(step_fn,
donate_argnums=(0,))`: `CompiledTrainStep` (posecnn),
`CompiledDetTrainStep` (detection), `CompiledSegTrainStep` (fcn8,
resnet50_seg), `CompiledVideoTrainStep` (recurrent_seg) and
`CompiledGanTrainStep` (the GAN, both updates in one program, as JAX
fuses them). On a card its call is one CUDA graph per batch signature
(`CompiledStep`, `utils/graph.compile_step`) holding forward, backward,
update and the metrics; on the CPU it runs the same body eagerly. The
data-parallel steps (the posecnn and GAN steps with a mesh of several
ranks) stay eager: their gloo collectives cannot be captured, and the
posecnn step's `max_pose_rois` cap keeps a data-dependent number of rows
(`torch.nonzero`, `models/posecnn.global_pose_row_cap`).

The detection step (`DetTrainStep`) is train_net_det's: the
`models.detection.detection_losses` terms with the ADD pose term, on one
COLOR image a step, with the same optimizer; its targets' sampling noise
is drawn a step from a generator seeded by (seed, step) (`det_noise_seed`).
The RPN's NMS scan runs on the device (`ops/nms.greedy_scan`), so the
step has no host read and its graph holds all of it.

The segmentation step (`SegTrainStep`, `make_seg_train_step` `:686-725`)
trains `FCN8` and `ResNet50Seg` on the normalised cross-entropy of their
log-probs against `label`, without dropout, as the JAX step does; the
video step (`VideoTrainStep`, `:728-757`) trains `RecurrentSegNet` on
`compute_video_losses`, the per-frame normalised cross-entropy averaged
over the sequence, backpropagated through time. Both use the same
optimizer.

The head switches gate the terms as in JAX: the vertex term with
`vertex_reg_2d or vertex_reg_3d` (3D vertex regression trains the same
head and term as 2D), the pose, magnitude, matching and domain terms with
`pose_reg` too; a seg-only model trains on the cross-entropy alone.

The GAN step (`GanTrainStep`, `make_gan_train_step` `:477-623`) trains the
PoseCNN as a generator against a `models.gan.FeatureDiscriminator` on
[255·vertex map ‖ image]: the generator's update takes the task losses
plus `gan_weight · E softplus(−D(fake))` under the cfg's optimizer; then
the discriminator's takes `gan_losses` of the real (the vertex targets)
and the detached fake maps under a constant-rate Adam (optax.adam: no
decay, no clip; fused and capturable on a card), both scored by the
discriminator as it was before the step.

The posecnn loop hands off when the host's resident memory passes
`train.max_host_rss_gb`: at a display iteration it snapshots and returns,
so a `--resume` run continues with no iteration lost
(`engine/train.py:446-458`). As in JAX, the GAN, detection, segmentation
and video loops do not check it.

Data parallelism (`parallel/mesh.py`; the JAX step with `mesh=`,
`:349-399`): with a `Mesh` of N data ranks, each rank steps on its share
of the global batch and the ranks together compute JAX's global-batch
step. Every loss term divides its local numerator by its normaliser
summed over the data group (the clamp and epsilon on the global count),
so the local totals sum to the global loss; the reported metrics are the
global values on every rank. After `backward`, before the optimizer adds
the weight decay, the gradients are summed (not averaged) over the data
group in one flat bucket, which gives the global-batch gradient. Data rank
d ≥ 1 draws its dropout from `SeedSequence([seed, step, d])` (rank 0 keeps
the one-card streams); the ranks of one model group share theirs. The GAN
step's softplus means are over equal local batches: each is scaled by
1/N, so the summed gradients are those of the global mean. Under tensor
parallelism (`param_sharding`) the clip's norm counts each fc6/fc7 shard
once. The loop decides the host-RSS handoff on all ranks together and
logs and snapshots on rank 0. With no mesh, or a world of one, nothing
of this runs: no collective, local normalisers, the same streams.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from posecnn_torch.core.config import Config
from posecnn_torch.models.detection import detection_losses
from posecnn_torch.models.gan import gan_losses
from posecnn_torch.ops.add_loss import average_distance_loss
from posecnn_torch.ops.hard_label import hard_label
from posecnn_torch.ops.losses import (
    build_vertex_targets,
    loss_cross_entropy_single_frame,
    smooth_l1_loss_vertex,
    softmax_cross_entropy_with_logits,
)
from posecnn_torch.ops.matching_loss import roi_matching_loss
from posecnn_torch.ops.rpn import target_noise
from posecnn_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    any_rank,
    loss_reduce,
    reduce_gradients,
    tp_partial_params,
    tp_sharded_params,
)
from posecnn_torch.utils.graph import compile_step, device_constant

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


INPUTS = ("COLOR", "RGBD", "DEPTH", "NORMAL")
SEG_FAMILIES = ("fcn8", "resnet50_seg")
FAMILIES = ("posecnn", "posecnn_det") + SEG_FAMILIES + ("recurrent_seg",)


def check_supported(cfg: Config) -> None:
    """Raise on a configuration the port's training path does not run:
    the posecnn family on COLOR, RGBD, DEPTH or NORMAL input, with any of
    its head switches (seg only, seg + 2D or 3D vertex, + pose), the
    domain-adaptation and matching losses and the GAN step, trains here;
    the detection family on COLOR; the segmentation (fcn8, resnet50_seg)
    and video (recurrent_seg) families on colour frames, whatever the
    input mode names. The GAN step needs a vertex head: the JAX one
    multiplies the missing vertex map (`engine/train.py:516-519`) and
    fails."""
    t = cfg.train
    posecnn = cfg.network == "posecnn"
    unsupported = {
        f"network={cfg.network!r}": cfg.network not in FAMILIES,
        f"input={cfg.input!r}": cfg.input not in (
            ("COLOR",) if cfg.network == "posecnn_det" else INPUTS),
        "train.gan without a vertex head (train.vertex_reg_2d and vertex_reg_3d off; the "
        "JAX GAN step fails on it too)": posecnn and t.gan and not vertex_reg(cfg),
    }
    bad = [name for name, hit in unsupported.items() if hit]
    if bad:
        raise NotImplementedError("the port's training path does not support: " + ", ".join(bad))


def vertex_reg(cfg: Config) -> bool:
    """Whether the posecnn model has its vertex head: 2D or 3D vertex
    regression (`posecnn_tpu/cli/train_net.py:557`)."""
    return bool(cfg.train.vertex_reg_2d or cfg.train.vertex_reg_3d)


def lr_schedule(cfg: Config) -> Callable[[int], float]:
    """Staircase exponential decay, evaluated on the optimizer's own
    update count plus `train.lr_step_offset`
    (`posecnn_tpu/engine/train.py:49-73`). The count starts at 0 with every
    fresh optimizer, a resumed one too; a posecnn resume sets the offset
    to the restored step (`cli/train_net`), so the staircase follows the
    global step while Adam starts again from its first, bias-corrected
    update (JAX's "restart kick")."""
    t = cfg.train

    def lr(count: int) -> float:
        count = count + t.lr_step_offset
        if t.stepsize <= 0:
            return t.learning_rate
        return t.learning_rate * t.gamma ** math.floor(count / t.stepsize)

    return lr


def logged_lr(cfg: Config, step: int) -> float:
    """The `lr` a step logs at the global `step` (the one before its
    update): `schedule(step − lr_step_offset)`, the offset added back by
    the schedule (`posecnn_tpu/engine/train.py:391`). The rate the update
    applies is `schedule(count)` on the optimizer's pass-local count. The
    two agree on a fresh run and on a posecnn resume (count 0, offset the
    step); a resumed GAN continues its step on a count from 0 with no
    offset, so it logs the staircase at the global step and applies it at
    the count, as JAX does."""
    return lr_schedule(cfg)(step - cfg.train.lr_step_offset)


def _weight_mask(params: Sequence[torch.Tensor]) -> list[bool]:
    """True for >1-D parameters (conv and dense kernels): biases are not
    regularised, as in the reference."""
    return [p.ndim > 1 for p in params]


class Optimizer:
    """optax.chain(masked(add_decayed_weights), clip_by_global_norm,
    sgd(momentum) | adam) over a list of parameters, updated in place from
    their `.grad` (`posecnn_tpu/engine/train.py:108-125`). The decay and
    the clip rewrite the gradients in place; optax's trace (`trace = g +
    μ·trace`, then `p −= lr·trace`, as `_foreach` ops) or
    `torch.optim.Adam` (the same bias-corrected moments) takes the last
    step. `sharded` are tensor-parallel shards whose squares the clip's
    norm sums over `shard_group` (each shard counted once).

    A form a CUDA graph can replay: the learning rate lives in the device
    tensor `lr`, which `prepare` sets to `schedule(count)` before each
    update, outside any graph; on the card Adam is fused and capturable
    with that tensor as its rate (its `step` and moments stay at their
    addresses), and the traces are made once, here. Missing gradients
    count as zeros made once and zeroed again each update. `update` is
    `prepare`, `apply` (the device part, which a graph captures) and the
    count, and `apply` is `condition` (the gradient transforms) then
    `descend` (the move); the eager and the compiled step both run it so."""

    def __init__(self, params: Sequence[torch.Tensor], *, kind: str, schedule: Callable,
                 weight_decay: float = 0.0, grad_clip: float = 0.0, momentum: float = 0.9,
                 sharded: Sequence[torch.Tensor] = (), shard_group=None):
        self.params = list(params)
        self.sharded = {id(p) for p in sharded}
        self.shard_group = shard_group
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.decayed = [p for p, m in zip(self.params, _weight_mask(self.params)) if m]
        self.grad_clip = grad_clip
        self.count = 0  # updates so far: the schedule's count
        on_card = self.params[0].is_cuda
        self.lr = torch.zeros((), dtype=torch.float32, device=self.params[0].device)
        self._zeros: dict[int, torch.Tensor] = {}  # the missing gradients', by index
        self.momentum, self.trace, self.opt = momentum, None, None
        if kind == "momentum":
            self.trace = [torch.zeros_like(p) for p in self.params]
        elif kind == "adam":
            # on the CPU torch.optim takes a tensor rate only fused or capturable
            self.opt = torch.optim.Adam(self.params, lr=self.lr if on_card else schedule(0),
                                        betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS, fused=on_card,
                                        capturable=on_card)
        else:
            raise ValueError(f"unknown optimizer '{kind}'")

    def update(self) -> float:
        """One update from the parameters' gradients (a missing gradient
        counts as zero, as in optax). Returns the learning rate it used."""
        lr = self.prepare()
        self.apply()
        self.count += 1
        return lr

    def prepare(self) -> float:
        """Set the rate of the next update, `schedule(count)`, and return it."""
        lr = self.schedule(self.count)
        if self.opt is not None and not isinstance(self.opt.param_groups[0]["lr"], torch.Tensor):
            self.opt.param_groups[0]["lr"] = lr
        else:
            self.lr.fill_(lr)
        return lr

    def state_tensors(self) -> list[torch.Tensor]:
        """Every tensor of the optimizer's state, at the address the update
        writes (Adam's made now where no update has made them yet)."""
        if self.trace is not None:
            return list(self.trace)
        return adam_state_tensors(self.opt)

    def apply(self) -> None:
        """The update's device work, at the rate `prepare` set."""
        self.condition()
        self.descend()

    @torch.no_grad()
    def condition(self) -> None:
        """The chain's gradient transforms, in place on `.grad`: a missing
        gradient as zeros, the masked weight decay, the global-norm clip."""
        for i, p in enumerate(self.params):
            if p.grad is None:
                zeros = self._zeros.get(i)
                if zeros is None:
                    zeros = self._zeros[i] = torch.zeros_like(p)
                else:
                    zeros.zero_()  # the decay and the clip rewrite it
                p.grad = zeros
        if self.weight_decay > 0 and self.decayed:
            # optax.masked(add_decayed_weights): g + wd · p on the kernels
            torch._foreach_add_([p.grad for p in self.decayed], self.decayed,
                                alpha=self.weight_decay)
        if self.grad_clip > 0:
            # clip_by_global_norm: where(norm < max, g, g / norm · max)
            g = [p.grad for p in self.params]
            if self.sharded:
                norm = self._sharded_norm()
            else:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            keep = norm < self.grad_clip
            torch._foreach_div_(g, torch.where(keep, torch.ones_like(norm), norm))
            torch._foreach_mul_(g, torch.where(keep, 1.0, self.grad_clip).to(norm))

    @torch.no_grad()
    def descend(self) -> None:
        """The move from the conditioned gradients at the rate `prepare` set."""
        if self.trace is None:
            self.opt.step()
            return
        # optax.sgd(lr, momentum): trace = g + μ·trace; p += −lr·trace
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, [p.grad for p in self.params])
        torch._foreach_sub_(self.params, torch._foreach_mul(self.trace, self.lr))

    def _sharded_norm(self) -> torch.Tensor:
        """The global norm with the shards' squares summed over their group."""
        def sq(grads):
            return torch.stack(torch._foreach_norm(grads)).square().sum()

        whole = sq([p.grad for p in self.params if id(p) not in self.sharded])
        shards = sq([p.grad for p in self.params if id(p) in self.sharded])
        return torch.sqrt(whole + all_reduce_sum(shards, self.shard_group))


def _adam_state(adam: torch.optim.Adam, p: torch.Tensor) -> dict:
    """`p`'s Adam state, made as Adam's first update makes it where there
    is none yet (zero moments, step 0: the next update is its first)."""
    state = adam.state[p]
    if not state:
        group = adam.param_groups[0]
        on_device = group["fused"] or group["capturable"]
        # torch.optim's scalar dtype: fp64 only for a non-fused fp64 default
        dtype = (torch.float64 if torch.get_default_dtype() == torch.float64 and not on_device
                 else torch.float32)
        state["step"] = torch.zeros((), dtype=dtype, device=p.device if on_device else "cpu")
        state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return state


def adam_state_tensors(adam: torch.optim.Adam) -> list[torch.Tensor]:
    """Every tensor of `adam`'s state, parameter by parameter, at the
    address its update writes (made now where no update has made them)."""
    return [t for group in adam.param_groups for p in group["params"]
            for t in _adam_state(adam, p).values()]


def fastforward_opt_counts(opt: Optimizer, step: int) -> Optimizer:
    """Set the optimizer's update count, which the schedule reads, and
    every parameter's `step` in the `torch.optim` state to `step`
    (`posecnn_tpu/engine/train.py:76-99` sets every optax `count`). Adam's
    bias correction is then that of an optimizer `step` updates old, with
    the moments it has. The count is written into the existing `step`
    tensor, which a captured update reads at its address. The momentum
    trace has no count. As in JAX, no resume calls it: a resume starts a
    fresh optimizer at count 0."""
    opt.count = step
    if opt.opt is not None:
        for p in opt.params:
            _adam_state(opt.opt, p)["step"].fill_(float(step))
    return opt


def create_optimizer(cfg: Config, params: Sequence[torch.Tensor], *,
                     sharded: Sequence[torch.Tensor] = (), shard_group=None) -> Optimizer:
    t = cfg.train
    return Optimizer(params, kind=t.optimizer.lower(), schedule=lr_schedule(cfg),
                     weight_decay=t.weight_reg, grad_clip=t.grad_clip, momentum=t.momentum,
                     sharded=sharded, shard_group=shard_group)


@dataclass
class TrainState:
    """The optimizer and the global step; the parameters live in the model."""

    opt: Optimizer
    step: int = 0

    def state_tensors(self) -> list[torch.Tensor]:
        """Every tensor of the optimizers' state, at the address an update
        writes."""
        return self.opt.state_tensors()


def create_train_state(cfg: Config, model: torch.nn.Module,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """The optimizer over `model`'s parameters (after `param_sharding`
    with a tensor-parallel mesh) at step 0."""
    shard_group = mesh.model_group if mesh is not None else None
    return TrainState(create_optimizer(cfg, list(model.parameters()),
                                       sharded=tp_sharded_params(model), shard_group=shard_group))


def decompress_feed(batch: dict, cfg: Config) -> dict:
    """Undo `data/pipeline.compact_feed` on the device: a uint8 image back
    to mean-subtracted fp32, a uint8 label to int64. Float feeds pass."""
    if batch.get("data") is None or batch["data"].dtype != torch.uint8:
        return batch
    b = dict(batch)
    b["data"] = b["data"].float() - device_constant(cfg.pixel_means, b["data"].device)
    if "label" in b:
        b["label"] = b["label"].long()
    return b


def dropout_seeds(seed: int, step: int, data_rank: int = 0) -> list[int]:
    """The seeds of the five dropout streams of one step (seg head, vertex
    head, fc6, fc7, fc9): `SeedSequence([seed, step])`'s words, and
    (seed, step, data_rank)'s on a data-parallel rank past the first,
    whose images must not repeat rank 0's masks. `generate_state` gives a
    prefix of the same words for fewer streams, so the first four are
    those of a model without the domain head."""
    entropy = [seed, step] if data_rank == 0 else [seed, step, data_rank]
    return [int(s) for s in np.random.SeedSequence(entropy).generate_state(5)]


def dropout_generators(seed: int, step: int, device, data_rank: int = 0) -> list[torch.Generator]:
    """Fresh generators of the five dropout streams of one step, seeded
    with `dropout_seeds`."""
    return [torch.Generator(device=device).manual_seed(s)
            for s in dropout_seeds(seed, step, data_rank)]


def compute_losses(model, batch: dict, cfg: Config, points, extents, symmetry,
                   generators: Sequence[Optional[torch.Generator]] = (None,) * 5,
                   keep_prob: float = 0.5, mesh: Optional[Mesh] = None):
    """Training forward + loss composition. batch keys: data (B, H, W, 3),
    label (B, H, W), meta (B, 48), gt_poses (G, 13), gt_valid (G,), and
    either vertex_targets / vertex_weights (B, H, W, 3C) or the sparse
    vertex_centers / vertex_logz / vertex_valid; data_p (B, H, W, 3) for
    RGBD; data and label may be uint8 (`compact_feed`). `keep_prob` is
    the dropout keep rate (the JAX step fixes 0.5; 1 switches dropout
    off). With a data-parallel `mesh`, `batch` is this rank's share and
    the losses and metrics are its share of the global batch's."""
    batch = decompress_feed(batch, cfg)
    out = model.train_forward(batch["data"], extents, batch["meta"], batch["gt_poses"],
                              batch.get("gt_valid"), data_p=batch.get("data_p"),
                              keep_prob=keep_prob, generators=generators, mesh=mesh)
    return _compose_losses_from_outputs(out, batch, cfg, points, extents, symmetry,
                                        loss_reduce(mesh))


def vertex_targets(batch: dict, cfg: Config):
    """The batch's dense vertex targets and weights, or those
    `build_vertex_targets` makes from the sparse feed on the device."""
    if "vertex_targets" in batch:
        return batch["vertex_targets"], batch["vertex_weights"]
    return build_vertex_targets(batch["label"], batch["vertex_centers"], batch["vertex_logz"],
                                batch["vertex_valid"], weight_inside=cfg.train.vertex_w_inside)


def _compose_losses_from_outputs(out, batch, cfg, points, extents, symmetry,
                                 reduce: Optional[Callable] = None):
    """Total loss and the metrics dict (`engine/train.py:177-309`): the
    vertex term with a vertex head, the pose terms with `pose_reg` too.
    `reduce` (`parallel/mesh.loss_reduce`) sums each term's normaliser and
    then the metrics over a data-parallel group: the total is this rank's
    share of the global loss, the metrics the global values."""
    t = cfg.train
    labels_w = hard_label(out.prob, batch["label"], t.threshold_label)
    loss_cls = loss_cross_entropy_single_frame(out.log_prob, labels_w, reduce)
    total = loss_cls
    metrics = {"loss_cls": loss_cls}
    if vertex_reg(cfg):
        v_targets, v_weights = vertex_targets(batch, cfg)
        loss_vertex = t.vertex_w * smooth_l1_loss_vertex(out.vertex_pred, v_targets, v_weights,
                                                         reduce=reduce)
        total = total + loss_vertex
        metrics["loss_vertex"] = loss_vertex
        if t.pose_reg:
            total = _pose_terms(out, batch, t, points, symmetry, total, metrics, reduce)
    metrics["loss"] = total
    metrics = {k: v.detach() for k, v in metrics.items()}
    if reduce is not None:
        # one all-reduce for every metric: shares and counts sum to the global values
        summed = reduce(torch.stack([v.float() for v in metrics.values()]))
        metrics = dict(zip(metrics, summed.unbind()))
    return total, metrics


def _pose_terms(out, batch, t, points, symmetry, total, metrics: dict,
                reduce: Optional[Callable] = None) -> torch.Tensor:
    """`total` plus the pose head's terms (`engine/train.py:209-306`),
    added in JAX's order: ADD(-S), the quaternion magnitude, matching and
    domain; each also goes into `metrics` (the counts this rank's)."""
    hough = out.hough
    # normalise by the weight-carrying valid rows (engine/train.py:211-227)
    weighted_rows = (hough.poses_weight.amax(dim=1) > 0) & hough.valid
    local_weighted = weighted_rows.float().sum()
    num_weighted = local_weighted if reduce is None else reduce(local_weighted)
    loss_pose = t.pose_w * average_distance_loss(
        out.poses_pred, hough.poses_target, hough.poses_weight, points, symmetry,
        margin=0.01, num_valid=num_weighted,
    )
    total = total + loss_pose
    metrics["loss_pose"] = loss_pose
    metrics["num_rois"] = hough.valid.float().sum()
    metrics["num_pose_rois"] = local_weighted

    if t.qmag_w > 0:
        masked = out.poses_tanh * hough.poses_weight
        mag = torch.sqrt((masked * masked).sum(dim=1) + 1e-12)
        loss_qmag = torch.where(weighted_rows, (mag - 1.0) ** 2, 0.0).sum() / torch.clamp(
            num_weighted, min=1.0)
        total = total + t.qmag_w * loss_qmag
        metrics["loss_qmag"] = loss_qmag

    if t.matching:
        # soft silhouettes of the weighted RoIs at their predicted poses
        # against the GT label mask at 1/8 (engine/train.py:264-291)
        loss_match, _ = roi_matching_loss(hough.rois, out.poses_pred, hough.poses_init,
                                          hough.poses_weight, hough.valid, batch["label"],
                                          batch["meta"], points, reduce=reduce)
        total = total + loss_match
        metrics["loss_match"] = loss_match

    if t.adapt and out.domain_logits is not None:
        dom_ce = softmax_cross_entropy_with_logits(out.domain_logits, hough.domains.long())
        mask = hough.valid.float()
        num_valid = mask.sum() if reduce is None else reduce(mask.sum())
        loss_domain = t.adapt_weight * (dom_ce * mask).sum() / (num_valid + 1e-10)
        total = total + loss_domain
        metrics["loss_domain"] = loss_domain
    return total


def loss_point_scale(points: torch.Tensor, extents: torch.Tensor, symmetry: torch.Tensor,
                     is_symmetric: bool):
    """ADD-loss points scaled per class by max(10, 2/max_extent), with
    symmetric classes ×4 once the SYMSIZE curriculum enables symmetry, and
    the symmetry flags zeroed before (`engine/train.py:328-346`).
    Returns (points_scaled, symmetry_effective)."""
    max_ext = extents.amax(dim=1)
    w = torch.where(max_ext > 1e-6, torch.clamp(2.0 / max_ext, min=10.0), 10.0)
    scale = w * torch.where((symmetry > 0) & is_symmetric, 4.0, 1.0)
    sym_eff = symmetry if is_symmetric else torch.zeros_like(symmetry)
    return points * scale[:, None, None], sym_eff


def step_losses(cfg: Config, model, points, extents, symmetry, batch: dict,
                generators: Sequence[Optional[torch.Generator]], is_symmetric: bool, *,
                keep_prob: float = 0.5, mesh: Optional[Mesh] = None):
    """(total loss, metrics) of the posecnn step on `batch`: the ADD points
    scaled for the SYMSIZE curriculum's phase, then `compute_losses`."""
    pts, sym = loss_point_scale(points, extents, symmetry, is_symmetric)
    return compute_losses(model, batch, cfg, pts, extents, sym, generators, keep_prob=keep_prob,
                          mesh=mesh)


class TrainStep:
    """One training step: `forward` (losses), `backward`, `update`;
    calling it (`eager`) runs the three and returns the metrics (tensors
    on the device, plus the host's `logged_lr`), one launch at a time. With
    a `mesh` it is one rank's part of the data-parallel step: `backward` also sums the
    gradients over the data group (`parallel/mesh.reduce_gradients`)."""

    # train_loop's host-RSS handoff: the posecnn step's alone, as in JAX
    host_rss_handoff = True
    # train_loop numbers the iterations from the state's step (JAX's
    # train_loop); the other families' loops number each pass from 1
    # (JAX's `_generic_loop`, posecnn_tpu/cli/train_net.py:54-66)
    continues_numbering = True

    def __init__(self, cfg: Config, model, points, extents, symmetry, *, keep_prob: float = 0.5,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.model = model
        self.points = points
        self.extents = extents
        self.symmetry = symmetry
        self.keep_prob = keep_prob
        self.mesh = mesh

    @property
    def data_rank(self) -> int:
        return self.mesh.data_index if self.mesh is not None else 0

    def models(self) -> tuple:
        """The modules the step trains, the model first."""
        return (self.model,)

    def forward(self, state: TrainState, batch: dict):
        """(total loss, metrics) of `batch` at the state's step."""
        cfg = self.cfg
        gens = dropout_generators(cfg.rng_seed, state.step, self.extents.device, self.data_rank)
        return step_losses(cfg, self.model, self.points, self.extents, self.symmetry, batch, gens,
                           state.step >= cfg.train.symsize, keep_prob=self.keep_prob,
                           mesh=self.mesh)

    def backward(self, total: torch.Tensor) -> None:
        self.model.zero_grad(set_to_none=True)
        total.backward()
        self.sync_gradients()

    def sync_gradients(self) -> None:
        """With a mesh, sum the gradients over the data group (and the
        column-parallel biases over the model group)."""
        if self.mesh is not None:
            reduce_gradients(list(self.model.parameters()), self.mesh,
                             tp_partial_params(self.model))

    def update(self, state: TrainState) -> float:
        """The optimizer update; returns the learning rate it used."""
        lr = state.opt.update()
        state.step += 1
        return lr

    def __call__(self, state: TrainState, batch: dict) -> dict:
        return self.eager(state, batch)

    def eager(self, state: TrainState, batch: dict) -> dict:
        """The step, one launch at a time (a compiled step's eager twin)."""
        total, metrics = self.forward(state, batch)
        self.backward(total)
        metrics["lr"] = logged_lr(self.cfg, state.step)
        self.update(state)
        return metrics


def _posecnn_losses(cfg: Config, model, points, extents, symmetry, keep_prob: float,
                    generators: Sequence[torch.Generator], batch: dict, is_symmetric: bool):
    """`step_losses` on the persistent dropout generators: the losses that
    `CompiledTrainStep` captures."""
    return step_losses(cfg, model, points, extents, symmetry, batch, generators, is_symmetric,
                       keep_prob=keep_prob)


def _compiled_body(losses: Callable, model, carry: Optional[torch.Tensor],
                   tail: Optional[Callable], batch: dict, opts: tuple, *static) -> dict:
    """The device work of one step, which `CompiledStep` captures: the
    family's losses (`losses(batch, *static)` → (total, metrics, *aux)),
    the backward, the update of `opts[0]` at the rate the host set, the
    family's `tail` where it has one (the GAN's discriminator update,
    `tail(batch, *aux, *opts[1:])` → its metrics, which join the step's),
    the metrics. With `carry` the step reads data + carry·1e-20 and writes
    its loss into carry. A function, not a method, so that what the
    compiled step keeps holds no reference back to the step."""
    if carry is not None:
        batch = {**batch, "data": batch["data"] + carry * 1e-20}
    total, metrics, *aux = losses(batch, *static)
    model.zero_grad(set_to_none=True)
    total.backward()
    opts[0].apply()
    if tail is not None:
        metrics.update(tail(batch, *aux, *opts[1:]))
    if carry is not None:
        carry.copy_(metrics["loss"])
    return metrics


class CompiledStep:
    """A family's training step as the JAX step's `jax.jit(step_fn,
    donate_argnums=(0,))`: calling it on a card runs forward, backward,
    update and the metrics as one CUDA graph per batch signature
    (`utils/graph.compile_step`: the batch's keys, shapes and dtypes, the
    optimizers, and the family's `static(state)`). The first call of a
    signature is its batch's real step, run eagerly; later calls copy the
    batch in and replay. Before each call the host seeds the family's
    persistent generators, which every graph registers, with
    `noise_seeds(state)` (the same words that seed the eager step's fresh
    generators, so both draw the same), and writes the learning rate into
    the optimizer's `lr`; after it, it counts the update and the step. The
    metrics are fresh tensors (the eager step's contract), `lr` the host's
    float (`logged_lr`). On the CPU the call runs the same body eagerly.

    A family mixes this into its eager step class and calls `_compile`
    with its losses on the persistent generators: a function of (batch,
    *static) that holds no reference to the step; a family with a second
    update (the GAN's discriminator) also passes its `tail` and names its
    optimizer in `optimizers(state)`. After a call each parameter of
    `models()` has as `.grad` the gradient its update used (the model's
    conditioned in place), as after the eager step: the graph's gradient
    tensors after a replay, the eager step's after a signature's first
    call. The eager step's `forward`, `backward` and `update` may be
    called between replays: they read and write the same parameters and
    optimizer state, and a replay reads those at their addresses;
    `step.eager(state, batch)` is the eager step. With `feedback` the body
    reads data + `carry`·1e-20 and writes its loss into the device scalar
    `carry`: the benches' chain of data-dependent steps."""

    def _compile(self, losses: Callable, generators: Sequence[torch.Generator], device, *,
                 tail: Optional[Callable] = None, feedback: bool = False) -> None:
        modules = self.models()
        self.generators = list(generators)
        self.carry = torch.zeros((), dtype=torch.float32, device=device) if feedback else None
        params, held = [p for m in modules for p in m.parameters()], {}

        def drop_gradients():  # before a capture: its backward allocates the graph's own
            held["eager"] = [p.grad for p in params]
            for m in modules:
                m.zero_grad(set_to_none=True)

        self._params, self._held, self._graph_grads = params, held, {}
        self.compiled = compile_step(partial(_compiled_body, losses, modules[0], self.carry, tail),
                                     generators=self.generators, before_capture=drop_gradients)

    def noise_seeds(self, state: TrainState) -> list[int]:
        """The seeds of the generators for the state's step."""
        return []

    def static(self, state: TrainState) -> tuple:
        """The losses' arguments after the batch, which the signature holds."""
        return ()

    def optimizers(self, state: TrainState) -> tuple:
        """The optimizers the body updates: the state's first, then the
        tail's."""
        return (state.opt,)

    def __call__(self, state: TrainState, batch: dict) -> dict:
        for g, seed in zip(self.generators, self.noise_seeds(state)):
            g.manual_seed(seed)
        state.opt.prepare()
        lr = logged_lr(self.cfg, state.step)
        metrics = self.compiled(batch, self.optimizers(state), *self.static(state))
        program = self.compiled.last
        if program is not None:
            grads = self._graph_grads.get(program)
            if grads is None:  # captured by this call: the eager step's gradients go back
                self._graph_grads[program] = [p.grad for p in self._params]
                grads = self._held.pop("eager")
            for p, g in zip(self._params, grads):
                p.grad = g
        state.opt.count += 1
        state.step += 1
        metrics["lr"] = lr
        return metrics


class CompiledTrainStep(CompiledStep, TrainStep):
    """The posecnn step compiled (`CompiledStep`;
    `posecnn_tpu/engine/train.py:349-400`): its generators are the five
    dropout streams, seeded with `dropout_seeds` of the state's step; its
    static argument is whether the SYMSIZE curriculum has switched
    symmetry on, which makes at most two graphs (the feed pads the GT rows
    to `max_gt`, so one batch signature serves a run). No mesh: the
    data-parallel step is `TrainStep`'s."""

    def __init__(self, cfg: Config, model, points, extents, symmetry, *, keep_prob: float = 0.5,
                 feedback: bool = False):
        TrainStep.__init__(self, cfg, model, points, extents, symmetry, keep_prob=keep_prob)
        device = extents.device
        generators = [torch.Generator(device=device) for _ in range(5)]
        self._compile(partial(_posecnn_losses, cfg, model, points, extents, symmetry, keep_prob,
                              generators), generators, device, feedback=feedback)

    def noise_seeds(self, state: TrainState) -> list[int]:
        return dropout_seeds(self.cfg.rng_seed, state.step)

    def static(self, state: TrainState) -> tuple:
        return (state.step >= self.cfg.train.symsize,)


def make_train_step(cfg: Config, model, points, extents, symmetry, *,
                    keep_prob: float = 0.5, mesh: Optional[Mesh] = None) -> TrainStep:
    """The posecnn step: compiled (`CompiledTrainStep`), or with a mesh of
    several ranks the eager data-parallel `TrainStep`."""
    check_supported(cfg)
    if mesh is not None and mesh.grid.size > 1:
        return TrainStep(cfg, model, points, extents, symmetry, keep_prob=keep_prob, mesh=mesh)
    return CompiledTrainStep(cfg, model, points, extents, symmetry, keep_prob=keep_prob)


@dataclass
class GanTrainState(TrainState):
    """The generator's optimizer and the step (`TrainState`), and the
    discriminator's constant-rate Adam; the parameters live in the two
    models."""

    d_opt: Optional[torch.optim.Optimizer] = None

    def state_tensors(self) -> list[torch.Tensor]:
        return [*self.opt.state_tensors(), *adam_state_tensors(self.d_opt)]


def discriminator_optimizer(cfg: Config, disc: torch.nn.Module) -> torch.optim.Adam:
    """optax.adam(learning_rate) over the discriminator: a constant rate,
    no decay, no clip (`engine/train.py:513`); on a card fused and
    capturable (its `step` on the device), as the compiled GAN step's
    graph needs it and the eager step uses it too."""
    d_params = list(disc.parameters())
    on_card = d_params[0].is_cuda
    return torch.optim.Adam(d_params, lr=cfg.train.learning_rate, betas=(ADAM_B1, ADAM_B2),
                            eps=ADAM_EPS, fused=on_card, capturable=on_card)


def create_gan_train_state(cfg: Config, model: torch.nn.Module,
                           disc: torch.nn.Module) -> GanTrainState:
    """The cfg's optimizer over the generator (the PoseCNN) and the
    discriminator's Adam (`engine/train.py:599-623`)."""
    return GanTrainState(create_optimizer(cfg, list(model.parameters())),
                         d_opt=discriminator_optimizer(cfg, disc))


def discriminator_input(vertex_map: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """[255·vertex map ‖ image] along channels (ref: vgg16_gan.py:151-156)."""
    return torch.cat([255.0 * vertex_map, data], dim=-1)


def _global_mean(local_mean: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A mean over this rank's images as its share of the mean over the
    global batch: the ranks' batches are equal, so 1/N of it."""
    return local_mean if loss_reduce(mesh) is None else local_mean / mesh.data_size


def _gan_metric(value: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    reduce = loss_reduce(mesh)
    return value.detach() if reduce is None else reduce(value.detach())


def _gan_losses(cfg: Config, model, disc, points, extents, symmetry, keep_prob: float,
                mesh: Optional[Mesh], generators: Sequence[torch.Generator], batch: dict):
    """(the generator's loss, metrics, the detached vertex map) of the GAN
    step: the task losses on the raw class points, as the JAX step passes
    them, plus `gan_weight` times the non-saturating adversarial term of
    the discriminator as it is, which takes no weight gradient."""
    batch = decompress_feed(batch, cfg)
    out = model.train_forward(batch["data"], extents, batch["meta"], batch["gt_poses"],
                              batch.get("gt_valid"), data_p=batch.get("data_p"),
                              keep_prob=keep_prob, generators=generators, mesh=mesh)
    total, metrics = _compose_losses_from_outputs(out, batch, cfg, points, extents, symmetry,
                                                  loss_reduce(mesh))
    disc.requires_grad_(False)
    fake_logits = disc(discriminator_input(out.vertex_pred, batch["data"]))
    disc.requires_grad_(True)
    g_adv = _global_mean(torch.nn.functional.softplus(-fake_logits).mean(), mesh)
    metrics["loss_g_adv"] = _gan_metric(g_adv, mesh)
    return total + cfg.train.gan_weight * g_adv, metrics, out.vertex_pred.detach()


def _discriminator_update(cfg: Config, disc, mesh: Optional[Mesh], batch: dict,
                          fake: torch.Tensor, d_opt: torch.optim.Optimizer) -> dict:
    """The discriminator's update on `batch`'s real vertex maps and the
    fake ones: {"loss_d": its loss} (over the global batch with a mesh,
    whose data group sums the gradients)."""
    batch = decompress_feed(batch, cfg)
    real, _ = vertex_targets(batch, cfg)
    real_logits = disc(discriminator_input(real, batch["data"]))
    fake_logits = disc(discriminator_input(fake, batch["data"]))
    d_loss = _global_mean(gan_losses(real_logits, fake_logits)[0], mesh)
    d_opt.zero_grad(set_to_none=True)
    d_loss.backward()
    if mesh is not None:
        reduce_gradients(list(disc.parameters()), mesh)
    d_opt.step()
    return {"loss_d": _gan_metric(d_loss, mesh)}


class GanTrainStep(TrainStep):
    """One adversarial vertex-map step (`make_gan_train_step`,
    `engine/train.py:485-577`), eager: `forward` gives the generator's
    loss, its metrics and the detached vertex map (`_gan_losses`),
    `backward` and `update` move the generator, and `discriminator` moves
    the discriminator on the real and that fake map. Both sides see the
    discriminator as it was before the step. Metrics: the task terms,
    `loss_g_adv`, `loss_d`, `lr`. The data-parallel GAN step (a mesh of
    several ranks) is this one; `CompiledGanTrainStep` is the step on one
    card."""

    host_rss_handoff = False
    continues_numbering = False

    def __init__(self, cfg: Config, model, disc, points, extents, symmetry, *,
                 keep_prob: float = 0.5, mesh: Optional[Mesh] = None):
        super().__init__(cfg, model, points, extents, symmetry, keep_prob=keep_prob, mesh=mesh)
        self.disc = disc

    def models(self) -> tuple:
        return (self.model, self.disc)

    def forward(self, state: GanTrainState, batch: dict):
        gens = dropout_generators(self.cfg.rng_seed, state.step, self.extents.device,
                                  self.data_rank)
        return _gan_losses(self.cfg, self.model, self.disc, self.points, self.extents,
                           self.symmetry, self.keep_prob, self.mesh, gens, batch)

    def discriminator(self, state: GanTrainState, batch: dict, fake: torch.Tensor):
        """The discriminator's update on `batch` and `forward`'s vertex
        map; returns its loss."""
        return _discriminator_update(self.cfg, self.disc, self.mesh, batch, fake,
                                     state.d_opt)["loss_d"]

    def eager(self, state: GanTrainState, batch: dict) -> dict:
        total, metrics, fake = self.forward(state, batch)
        self.backward(total)
        lr = logged_lr(self.cfg, state.step)
        self.update(state)
        metrics["loss_d"] = self.discriminator(state, batch, fake)
        metrics["lr"] = lr
        return metrics


class CompiledGanTrainStep(CompiledStep, GanTrainStep):
    """The GAN step compiled (`CompiledStep`; JAX fuses both updates into
    one `jax.jit(step_fn, donate_argnums=(0,))`,
    `posecnn_tpu/engine/train.py:485-577`): one graph holds the
    generator's forward on the five dropout streams (seeded with
    `dropout_seeds`, as `CompiledTrainStep` seeds them), the adversarial
    term, the backward and the generator's update, then as the tail the
    discriminator's real and fake passes, its backward and its Adam
    update, and the metrics. No mesh."""

    def __init__(self, cfg: Config, model, disc, points, extents, symmetry, *,
                 keep_prob: float = 0.5):
        GanTrainStep.__init__(self, cfg, model, disc, points, extents, symmetry,
                              keep_prob=keep_prob)
        device = extents.device
        generators = [torch.Generator(device=device) for _ in range(5)]
        self._compile(partial(_gan_losses, cfg, model, disc, points, extents, symmetry,
                              keep_prob, None, generators), generators, device,
                      tail=partial(_discriminator_update, cfg, disc, None))

    def noise_seeds(self, state: TrainState) -> list[int]:
        return dropout_seeds(self.cfg.rng_seed, state.step)

    def optimizers(self, state: GanTrainState) -> tuple:
        return (state.opt, state.d_opt)


def make_gan_train_step(cfg: Config, model, disc, points, extents, symmetry, *,
                        keep_prob: float = 0.5, mesh: Optional[Mesh] = None) -> GanTrainStep:
    """The GAN step: compiled (`CompiledGanTrainStep`), or with a mesh of
    several ranks the eager data-parallel `GanTrainStep`."""
    check_supported(cfg)
    if mesh is not None and mesh.grid.size > 1:
        return GanTrainStep(cfg, model, disc, points, extents, symmetry, keep_prob=keep_prob,
                            mesh=mesh)
    return CompiledGanTrainStep(cfg, model, disc, points, extents, symmetry,
                                keep_prob=keep_prob)


def det_noise_seed(seed: int, step: int) -> int:
    """The seed of the detection step's sampling stream: the first word of
    `SeedSequence([seed, step])`."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def det_noise_generator(seed: int, step: int, device) -> torch.Generator:
    """The detection step's sampling stream, seeded from (seed, step)."""
    return torch.Generator(device=device).manual_seed(det_noise_seed(seed, step))


def _det_losses(model, points, symmetry, generator: torch.Generator, batch: dict):
    """(total loss, metrics) of the detection step on `batch`, the targets'
    noise drawn from `generator`."""
    data = batch["data"]
    noise = target_noise(*model.noise_shapes(data.shape[1], data.shape[2],
                                             batch["gt_boxes"].shape[0]), generator, data.device)
    out = model(data, batch["gt_boxes"], batch["gt_poses"], batch["gt_valid"], train=True,
                noise=noise)
    metrics = detection_losses(out, model.num_classes, points, symmetry)
    return metrics["loss"], {k: v.detach() for k, v in metrics.items()}


class DetTrainStep(TrainStep):
    """One detection training step (`engine/train.py:647-684`): the
    forward with the targets' noise of this step, `detection_losses` with
    the pose term when points and symmetry are given, then the shared
    backward and update. batch keys: data (1, H, W, 3), gt_boxes (G, 5),
    gt_poses (G, 13), gt_valid (G,)."""

    host_rss_handoff = False
    continues_numbering = False

    def __init__(self, cfg: Config, model, points=None, symmetry=None):
        super().__init__(cfg, model, points, None, symmetry)

    def forward(self, state: TrainState, batch: dict):
        gen = det_noise_generator(self.cfg.rng_seed, state.step, batch["data"].device)
        return _det_losses(self.model, self.points, self.symmetry, gen, batch)


class CompiledDetTrainStep(CompiledStep, DetTrainStep):
    """The detection step compiled (`CompiledStep`; JAX's
    `make_det_train_step` returns `jax.jit(step_fn, donate_argnums=(0,))`,
    `posecnn_tpu/engine/train.py:647-680`): its one generator is the
    targets' sampling stream, seeded with `det_noise_seed` of the state's
    step. `det_targets` pads the GT rows to 8, so one graph serves a run;
    the RPN's NMS runs inside it on the device scan (`ops/nms.greedy_scan`)."""

    def __init__(self, cfg: Config, model, points=None, symmetry=None):
        DetTrainStep.__init__(self, cfg, model, points, symmetry)
        device = next(model.parameters()).device
        generator = torch.Generator(device=device)
        self._compile(partial(_det_losses, model, points, symmetry, generator), [generator],
                      device)

    def noise_seeds(self, state: TrainState) -> list[int]:
        return [det_noise_seed(self.cfg.rng_seed, state.step)]


def make_det_train_step(cfg: Config, model, points=None, symmetry=None) -> CompiledDetTrainStep:
    """The detection step, compiled (`CompiledDetTrainStep`)."""
    check_supported(cfg)
    return CompiledDetTrainStep(cfg, model, points, symmetry)


def train_loop(cfg: Config, model, state: TrainState, batch_iter, points, extents, symmetry, *,
               max_iters: Optional[int] = None,
               log_fn: Optional[Callable[[int, dict], None]] = None,
               snapshot_fn: Optional[Callable[[int, TrainState], None]] = None,
               step: Optional[TrainStep] = None, mesh: Optional[Mesh] = None) -> TrainState:
    """Host loop (`engine/train.py:403-462`): one step per batch, the
    metrics every `display` iterations, a snapshot every
    `snapshot_iters`. The posecnn step's loop continues a restored state's
    numbering up to `max_iters`; the other families' (a step whose
    `continues_numbering` is false: JAX's `_generic_loop`) take
    `max_iters` steps numbered from 1, whatever the state's step. `step`
    defaults to the posecnn family's (with `mesh`). With `train.max_host_rss_gb` > 0
    the posecnn step's loop checks the host's RSS at each display
    iteration and, past the limit, snapshots at that iteration and
    returns. With a `mesh` of several ranks the limit is judged on all of
    them together (one rank past it stops every rank at that iteration,
    where the next step's all-reduce would otherwise wait for it), and
    only rank 0 logs and snapshots."""
    max_iters = max_iters or cfg.train.max_iters
    step = step or make_train_step(cfg, model, points, extents, symmetry, mesh=mesh)
    chief = mesh is None or mesh.rank == 0
    if not chief:
        log_fn, snapshot_fn = (lambda it_num, metrics: None), None
    start = state.step if step.continues_numbering else 0
    if start >= max_iters and chief:
        print(f"train_loop: restored step {start} >= max_iters {max_iters}; nothing to do "
              "(raise --iters to continue training)", flush=True)
    t_start = time.time()
    for it in range(start, max_iters):
        metrics = step(state, next(batch_iter))
        if (it + 1) % cfg.train.display == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["s_per_iter"] = (time.time() - t_start) / (it + 1 - start)
            if log_fn is not None:
                log_fn(it + 1, metrics)
            else:
                line = ", ".join(f"{k}: {v:.4f}" for k, v in metrics.items())
                print(f"iter {it + 1}/{max_iters} " + line, flush=True)
            limit = cfg.train.max_host_rss_gb
            over = limit > 0 and step.host_rss_handoff and (rss := host_rss_gb()) > limit
            if limit > 0 and step.host_rss_handoff and mesh is not None:
                over = any_rank(over, mesh.world_group, extents.device)
            if over:
                if chief:
                    where = "" if mesh is None else " on a rank"
                    print(f"host RSS past {limit} GB{where} (this process {rss:.1f} GB) — "
                          "snapshotting and exiting for a clean resume", flush=True)
                if snapshot_fn is not None:
                    snapshot_fn(it + 1, state)
                return state
        if snapshot_fn is not None and (it + 1) % cfg.train.snapshot_iters == 0:
            snapshot_fn(it + 1, state)
    return state


def host_rss_gb() -> float:
    """This process's resident set size in GB (`VmRSS` of
    /proc/self/status; 0 where there is none)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def seg_cross_entropy(log_prob: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """−Σ onehot(label)·log_prob / (Σ onehot + 1e-10) over every leading
    axis: the normalised cross-entropy (ref: loss_cross_entropy
    train.py:440-465). A label outside [0, C) has an all-zero one-hot row,
    as `jax.nn.one_hot` gives it."""
    c = log_prob.shape[-1]
    label = label.long()
    inside = (label >= 0) & (label < c)
    picked = log_prob.gather(-1, label.clamp(0, c - 1)[..., None])[..., 0]
    return -(picked * inside).sum() / (inside.sum() + 1e-10)


def _seg_losses(model, batch: dict):
    """(loss, metrics) of the segmentation step: the normalised
    cross-entropy of the model's log-probs on `data` against `label`."""
    log_prob, _ = model(batch["data"])
    loss = seg_cross_entropy(log_prob, batch["label"])
    return loss, {"loss": loss.detach(), "loss_cls": loss.detach()}


class SegTrainStep(TrainStep):
    """One segmentation step (`engine/train.py:686-725`): the model's
    log-probs on `data` (B, H, W, 3), the normalised cross-entropy against
    `label` (B, H, W). No dropout: the JAX step passes no keep rate."""

    host_rss_handoff = False
    continues_numbering = False

    def __init__(self, cfg: Config, model):
        super().__init__(cfg, model, None, None, None)

    def forward(self, state: TrainState, batch: dict):
        return _seg_losses(self.model, batch)


class CompiledSegTrainStep(CompiledStep, SegTrainStep):
    """The segmentation step compiled (`CompiledStep`; JAX's
    `make_seg_train_step` returns `jax.jit(step_fn, donate_argnums=(0,))`,
    `posecnn_tpu/engine/train.py:683-725`): one graph per batch signature,
    data (B, H, W, 3) and label (B, H, W). No generator: no dropout."""

    def __init__(self, cfg: Config, model):
        SegTrainStep.__init__(self, cfg, model)
        self._compile(partial(_seg_losses, model), [], next(model.parameters()).device)


def make_seg_train_step(cfg: Config, model) -> CompiledSegTrainStep:
    """The segmentation step (fcn8, resnet50_seg), compiled."""
    check_supported(cfg)
    return CompiledSegTrainStep(cfg, model)


def compute_video_losses(model, frames, depths, metas, gt_labels):
    """Per-frame normalised cross-entropy of the recurrent net over a
    sequence, averaged over the frames (`engine/train.py:626-644`).
    frames (T, B, H, W, 3), depths (T, B, H, W), metas (T, B, 48),
    gt_labels (T, B, H, W) → (loss, {"loss", "per_step" (T,), "labels_pred"})."""
    log_probs, labels_pred, _ = model(frames, depths, metas)
    per_step = torch.stack([seg_cross_entropy(lp, gt) for lp, gt in zip(log_probs, gt_labels)])
    loss = per_step.mean()
    return loss, {"loss": loss, "per_step": per_step, "labels_pred": labels_pred}


def _video_losses(model, batch: dict):
    """(loss, metrics) of the video step: `compute_video_losses` on a
    batch of sequences."""
    loss, _ = compute_video_losses(model, batch["image"], batch["depth"], batch["meta"],
                                   batch["label"])
    return loss, {"loss": loss.detach()}


class VideoTrainStep(TrainStep):
    """One video step (`engine/train.py:728-757`): `compute_video_losses`
    on a batch of sequences {image, depth, meta, label}, time-major."""

    host_rss_handoff = False
    continues_numbering = False

    def __init__(self, cfg: Config, model):
        super().__init__(cfg, model, None, None, None)

    def forward(self, state: TrainState, batch: dict):
        return _video_losses(self.model, batch)


class CompiledVideoTrainStep(CompiledStep, VideoTrainStep):
    """The video step compiled (`CompiledStep`; JAX's
    `make_video_train_step` returns `jax.jit(step_fn,
    donate_argnums=(0,))`, `posecnn_tpu/engine/train.py:728-757`): one
    graph per (T, B, H, W) of image / depth / meta / label, the whole
    unrolled sequence with its backward through time."""

    def __init__(self, cfg: Config, model):
        VideoTrainStep.__init__(self, cfg, model)
        self._compile(partial(_video_losses, model), [], next(model.parameters()).device)


def make_video_train_step(cfg: Config, model) -> CompiledVideoTrainStep:
    """The video step (recurrent_seg), compiled."""
    check_supported(cfg)
    return CompiledVideoTrainStep(cfg, model)
