"""One data- and tensor-parallel training step held against one process.

Counterpart of `__graft_entry__.dryrun_multichip` (`:70-190`):
`dryrun_multichip(n)` spawns n ranks, each with the same tiny PoseCNN
(4 classes, 48×64, num_units 16, fc_dim 64, 32 Hough samples, 2 objects
an image, cell stride 2, fp32) and its share of one global batch
(`gen.minibatch(n)` at seed 3), runs one step at keep_prob 1 on a (n/2
data × 2 model) mesh when n is even (fc6/fc7 column-parallel), pure data
parallel otherwise, and holds the loss and every updated parameter to
the one-process step on the same batch and weights, with JAX's asserts
(|Δloss| < 1e-3, max|Δparam| < 5e-3).

`StepCase`, `step_once` and `run_ranks` are the harness under it,
which the tests and `chip_smoke.py` also drive: one step of a case in
this process, or on a mesh of spawned ranks, with the loss terms, the
gradients after the data group's sum and the updated parameters (fc6/fc7
gathered from the model ranks) of each.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from posecnn_torch.cli.common import setup_device
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.data.pipeline import make_sharded_device_put
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine.train import (
    GanTrainState,
    create_train_state,
    discriminator_optimizer,
    make_gan_train_step,
    make_train_step,
)
from posecnn_torch.models.gan import FeatureDiscriminator
from posecnn_torch.models.posecnn import PoseCNN, init_weights
from posecnn_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    gather_fc_state,
    param_sharding,
    spawn_ranks,
)

# JAX's asserts in dryrun_multichip (`__graft_entry__.py:186-187`)
DLOSS_BAR, DPARAM_BAR = 1e-3, 5e-3


@dataclass
class StepCase:
    """One training step: the cfg (`cfg_from_dict`'s input), the PoseCNN
    (its kwargs and initial state dict), the GLOBAL host batch, the loss
    geometry (raw class points, extents, symmetry; the step scales the
    points), the keep rate, and for the GAN step the discriminator's
    initial state."""

    cfg: dict
    num_classes: int
    model_kw: dict
    state: dict
    batch: dict
    points: np.ndarray
    extents: np.ndarray
    symmetry: np.ndarray
    keep_prob: float = 1.0
    disc_state: Optional[dict] = None


@dataclass
class StepResult:
    """A step's metrics (floats), the gradients it applied and the
    parameters after it (CPU tensors by state-dict name; the
    discriminator's under `disc.`)."""

    metrics: dict
    grads: dict
    params: dict
    per_rank_metrics: list = field(default_factory=list)


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}


def step_once(case: StepCase, device, mesh: Optional[Mesh] = None) -> StepResult:
    """One step of `case` on `device`; with a `mesh`, this rank's part of
    it, on its share of the global batch. TF32 is off (`setup_device`)."""
    device = setup_device(str(device))
    cfg = cfg_from_dict(case.cfg)
    model = PoseCNN(case.num_classes, **case.model_kw)
    model.load_state_dict(case.state)
    if mesh is not None:
        param_sharding(mesh, model, shard_fc=True)
    model = model.to(device)
    state = create_train_state(cfg, model, mesh)
    pts, ext, sym = (torch.from_numpy(np.asarray(a, np.float32)).to(device)
                     for a in (case.points, case.extents, case.symmetry))
    disc = None
    if case.disc_state is not None:
        disc = FeatureDiscriminator(3 * case.num_classes + 3)
        disc.load_state_dict(case.disc_state)
        disc = disc.to(device)
        state = GanTrainState(state.opt, state.step, d_opt=discriminator_optimizer(cfg, disc))
        step = make_gan_train_step(cfg, model, disc, pts, ext, sym, keep_prob=case.keep_prob,
                                   mesh=mesh)
    else:
        step = make_train_step(cfg, model, pts, ext, sym, keep_prob=case.keep_prob, mesh=mesh)
    batch = make_sharded_device_put(mesh, device=device)(case.batch)
    total, metrics, *fake = step.forward(state, batch)  # the GAN's forward gives its vertex map
    step.backward(total)
    grads = _cpu({n: p.grad for n, p in model.named_parameters()})
    step.update(state)
    params = _cpu(model.state_dict())
    if disc is not None:
        metrics["loss_d"] = step.discriminator(state, batch, *fake)
        grads.update(_cpu({f"disc.{n}": p.grad for n, p in disc.named_parameters()}))
        params.update({f"disc.{k}": v for k, v in _cpu(disc.state_dict()).items()})
    return StepResult({k: float(v) for k, v in metrics.items()}, grads, params)


Job = Tuple[Sequence[StepCase], int, int]  # cases, num_data, num_model


def _rank(rank: int, device: torch.device, jobs: Sequence[Job], out_dir: str) -> None:
    results = []
    for cases, num_data, num_model in jobs:
        mesh = create_mesh(num_data, num_model)
        results.append([step_once(c, device, mesh) for c in cases])
    torch.save(results, os.path.join(out_dir, f"{rank}.pt"))


def run_ranks(jobs: Sequence[Job], *, devices: Sequence[str], backend: str,
              num_threads: int = 0) -> list:
    """One step of each case of each job `(cases, num_data, num_model)` on
    one spawn of `len(devices)` ranks, the jobs in turn, each on its
    (num_data × num_model) mesh of all the ranks. Returns, per job, a
    `StepResult` per case: data rank 0's, with fc6/fc7 (and their
    gradients) gathered over its model row, and every rank's metrics in
    `per_rank_metrics`."""
    n = len(devices)
    if any(num_data * num_model != n for _, num_data, num_model in jobs):
        raise ValueError(f"every job's mesh must span the {n} ranks: "
                         f"{[(d, m) for _, d, m in jobs]}")
    with tempfile.TemporaryDirectory(prefix="posecnn_ranks_") as out:
        spawn_ranks(_rank, n, ([(list(c), d, m) for c, d, m in jobs], out), devices=devices,
                    backend=backend, rendezvous_dir=out, num_threads=num_threads)
        ranks = [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False) for r in range(n)]
    results = []
    for j, (cases, _, num_model) in enumerate(jobs):
        gather = gather_fc_state if num_model > 1 else (lambda states: states[0])
        job = []
        for i in range(len(cases)):
            row = [ranks[r][j][i] for r in range(num_model)]  # data rank 0's model ranks
            job.append(StepResult(row[0].metrics, gather([r.grads for r in row]),
                                  gather([r.params for r in row]),
                                  [ranks[r][j][i].metrics for r in range(n)]))
        results.append(job)
    return results


def dryrun_case(n: int) -> StepCase:
    """`dryrun_multichip`'s step at a global batch of n images: JAX's
    config, class geometry (`RandomState(0)` points) and scenes (seed 3),
    the port's seeded initialisation."""
    num_classes, h, w, p_pts = 4, 48, 64, 32
    rng = np.random.RandomState(0)
    points = (rng.rand(num_classes, p_pts, 3).astype(np.float32) - 0.5) * 0.12
    points[0] = 0
    extents = np.abs(points).max(1) * 2.0
    k = np.array([[150.0, 0, w / 2], [0, 150.0, h / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(points, extents, k, width=w, height=h, min_objects=1,
                                  max_objects=2, t_near=0.6, t_far=1.2, seed=3)
    model_kw = dict(num_units=16, fc_dim=64, hough_num_samples=32, max_objects=2,
                    hough_cell_stride=2)
    model = PoseCNN(num_classes, **model_kw)
    init_weights(model, 0)
    return StepCase(
        cfg={"train": {"num_classes": num_classes, "vertex_reg_2d": True, "pose_reg": True,
                       "ims_per_batch": n}},
        num_classes=num_classes, model_kw=model_kw, state=model.state_dict(),
        batch=gen.minibatch(n), points=points, extents=extents,
        symmetry=np.zeros(num_classes, np.float32))


def parity(one: StepResult, many: StepResult) -> tuple:
    """(|Δloss|, max|Δparam|) between two results of one case."""
    dloss = abs(one.metrics["loss"] - many.metrics["loss"])
    dparam = max(float((one.params[k].float() - many.params[k].float()).abs().max())
                 for k in one.params)
    return dloss, dparam


def dryrun_multichip(n_devices: int, *, device: str = "cuda",
                     backend: Optional[str] = None) -> dict:
    """The full sharded training step on n ranks against one process (see
    the module docstring). Ranks run on `cuda:r` (modulo the cards) over
    NCCL, or on the CPU over gloo; `backend` overrides (gloo puts several
    ranks on one card). Raises past JAX's bars; prints its one line and
    returns {"loss", "dloss", "dparam", "num_data", "num_model"}."""
    cuda = torch.device(device).type == "cuda"
    num_model = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    num_data = n_devices // num_model
    case = dryrun_case(n_devices)
    one = step_once(case, device)
    cards = torch.cuda.device_count() if cuda else 0
    devices = [f"cuda:{r % cards}" if cuda else "cpu" for r in range(n_devices)]
    many = run_ranks([([case], num_data, num_model)], devices=devices,
                     backend=backend or ("nccl" if cuda else "gloo"),
                     num_threads=0 if cuda else 1)[0][0]
    loss = many.metrics["loss"]
    if not np.isfinite(loss):
        raise AssertionError(f"sharded step produced non-finite loss {loss}")
    dloss, dparam = parity(one, many)
    if not dloss < DLOSS_BAR:
        raise AssertionError(f"DP/TP loss parity broken: |Δloss|={dloss}")
    if not dparam < DPARAM_BAR:
        raise AssertionError(f"DP/TP param parity broken: max|Δparam|={dparam}")
    print(f"dryrun_multichip({n_devices}): ok (data={num_data}×model={num_model}), "
          f"loss={loss:.4f}, parity vs 1-device: |Δloss|={dloss:.2e}, max|Δparam|={dparam:.2e}",
          flush=True)
    return {"loss": loss, "dloss": dloss, "dparam": dparam, "num_data": num_data,
            "num_model": num_model}
