"""The detection family's compiled programs on the CPU, at the tiny sizes
of tests/test_torch_detection.py (64×96 frames, 4 classes, fc_dim 32, 16
proposal slots, 3×3 anchors): the training step
(`engine/train.CompiledDetTrainStep`, the counterpart of the JAX step's
`jax.jit(step_fn, donate_argnums=(0,))`) and `test_net`'s `det_infer` and
`det_pose` (`cli/test_net.py`, JAX's jitted `infer` and `det_pose`), with
the NMS scan they run (`ops/nms.greedy_scan`).

- The plain scan (the CPU's, and the kernel's plain version) keeps what
  `greedy_keep`'s host loop and JAX's `nms` keep, bit for bit: tied
  scores, no valid row, no kills, N = 1, N = 33, leading dims (1,), (3,).
- On the CPU the compiled det step runs its body eagerly; over 3 steps,
  across a step of the lr staircase, it equals the eager `DetTrainStep`
  bit for bit (every metric, lr, parameter and momentum trace).
- The same 3 steps against JAX's `jax.jit(make_det_train_step(...))`, run
  in a child process with its XLA capped at AVX, from the same weights
  and with JAX's own target draws, at test_torch_detection's tolerances.
- The constants the det programs built on the host every call are device
  buffers made once, equal to the old values; after a first call, no
  step, `det_infer` or `det_pose` builds a host constant or reads a
  tensor on the host (a CUDA graph captures neither).
- The re-seeded persistent noise generator draws what
  `det_noise_generator` draws.
- `test_net`'s detection evaluation through the compiled wrappers equals
  the eager loop it replaced (host scan, unpadded depth fit), bit for bit.

The CUDA graphs run only on a card: the `cuda` tests hold replayed det
steps to eager steps from the same state, count one scan launch a replay
on the device, and hold the two `test_net` programs' replays to their
eager bodies (`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_det_compiled.py`). JAX is imported inside the tests that
use it: the card's machine has none.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from posecnn_torch import bench
from posecnn_torch.cli import test_net
from posecnn_torch.cli.train_net import det_targets
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine import train as ttrain
from posecnn_torch.models.detection import PoseCNNDet
from posecnn_torch.models.posecnn import init_weights
from posecnn_torch.ops import _cuda, rpn
from posecnn_torch.ops.nms import Suppression, box_suppression, greedy_keep, nms
from posecnn_torch.utils.bbox import bbox_transform_inv, clip_boxes
from posecnn_torch.utils.graph import device_constant
from test_torch_compiled_train import max_distance, one_step, state_of

torch.set_num_threads(1)
C, FC, H, W, STEPS = 4, 32, 64, 96, 3
KW = dict(anchor_scales=(1, 2, 4), anchor_ratios=(0.5, 1.0, 2.0), fc_dim=FC, post_nms_topk=16,
          pre_nms_topk=100, rois_per_image=16, rpn_batchsize=32, rpn_positive_overlap=0.5,
          bg_thresh_lo=0.0)
# momentum across a step of the lr staircase (count 2)
TRAIN = {"num_classes": C, "fc_dim": FC, "optimizer": "momentum", "learning_rate": 0.001,
         "momentum": 0.9, "weight_reg": 1e-4, "syn_height": H, "syn_width": W, "stepsize": 2,
         "gamma": 0.5}
TOY = ["--set", "network=posecnn_det", "compute_dtype=float32", f"train.num_classes={C}",
       f"train.syn_height={H}", f"train.syn_width={W}", "train.fc_dim=32",
       "anchor_scales=[1,2,4]", "anchor_ratios=[0.5,1.0,2.0]", "test.rpn_post_nms_top_n=16",
       "test.rpn_pre_nms_top_n=100"]


def toy_data():
    """STEPS rendered detection batches, the ADD points (48 a class) and
    the symmetry flags, class 1 symmetric."""
    lib = synthetic_class_library(C, 256)
    k = np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=W, height=H, seed=4,
                                  min_objects=2, max_objects=3, point_colors=lib.colors,
                                  point_normals=lib.normals)
    batches = [det_targets(gen.render(dense_vertex_targets=False)) for _ in range(STEPS)]
    sym = np.asarray(lib.symmetry, np.float32).copy()
    sym[1] = 1.0
    return batches, np.ascontiguousarray(lib.points[:, :48]), sym


def port_step(pts, sym, cls=None, device="cpu"):
    """(step, state) of the toy detection model on seeded weights."""
    cfg = cfg_from_dict({"network": "posecnn_det", "train": TRAIN})
    model = PoseCNNDet(C, **KW)
    init_weights(model, 0)
    model = model.to(device)
    step = (cls or ttrain.make_det_train_step)(cfg, model, torch.from_numpy(pts).to(device),
                                               torch.from_numpy(sym).to(device))
    return step, ttrain.create_train_state(cfg, model)


def tb(batch, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in batch.items()}


def nms_case(name):
    """(boxes (L, N, 4), scores (L, N), valid (L, N)) made with numpy."""
    rng = np.random.RandomState(["ties", "all_invalid", "no_kills", "n1", "n33",
                                 "lead3"].index(name))
    lead, n = {"n1": (1, 1), "n33": (1, 33), "lead3": (3, 40)}.get(name, (1, 48))
    xy = rng.uniform(0, 80, (lead, n, 2))
    wh = rng.uniform(8, 40, (lead, n, 2))
    if name == "no_kills":  # a grid of disjoint boxes
        xy = np.stack(np.meshgrid(np.arange(8) * 50.0, np.arange(6) * 50.0), -1).reshape(1, n, 2)
        wh = np.full((1, n, 2), 30.0)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.rand(lead, n).astype(np.float32)
    scores[:, ::3] = 0.25  # ties: input order decides
    valid = rng.rand(lead, n) > 0.2
    if name == "all_invalid":
        valid[:] = False
    return boxes, scores, valid


@pytest.mark.parametrize("case", ["ties", "all_invalid", "no_kills", "n1", "n33", "lead3"])
def test_plain_scan_keeps_what_greedy_keep_and_jax_keep(case):
    import jax.numpy as jnp

    from posecnn_tpu.ops.nms import nms as jax_nms

    boxes, scores, valid = nms_case(case)
    threshold = 0.3
    tboxes, tscores, tvalid = map(torch.from_numpy, (boxes, scores, valid))
    got = nms(tboxes, tscores, threshold, valid=tvalid)
    host = greedy_keep(box_suppression(tboxes, tscores, threshold, tvalid))
    assert torch.equal(got, host)
    for i in range(len(boxes)):
        want = np.asarray(jax_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), threshold,
                                  valid=jnp.asarray(valid[i])))
        np.testing.assert_array_equal(got[i].numpy(), want, err_msg=f"{case} row {i}")
    if case == "all_invalid":
        assert not got.any()
    if case == "no_kills":
        assert torch.equal(got, torch.from_numpy(valid))


def test_compiled_det_step_on_the_cpu_equals_the_eager_step():
    batches, pts, sym = toy_data()
    eager, eager_state = port_step(pts, sym, cls=ttrain.DetTrainStep)
    compiled, compiled_state = port_step(pts, sym)
    assert isinstance(compiled, ttrain.CompiledDetTrainStep)
    lrs = []
    for i, batch in enumerate(batches):
        want, got = eager(eager_state, tb(batch)), compiled(compiled_state, tb(batch))
        assert set(got) == set(want) == {"rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box",
                                         "loss_pose", "loss", "lr"}
        assert got["lr"] == want["lr"] and isinstance(got["lr"], float)
        for k in want:
            assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k])), (i, k)
        lrs.append(got["lr"])
        for a, b in zip(state_of(compiled, compiled_state), state_of(eager, eager_state)):
            assert torch.equal(a, b), i
    assert lrs == [1e-3, 1e-3, 5e-4]
    assert compiled_state.step == eager_state.step == STEPS
    assert compiled.compiled.programs == {}  # no graph on the CPU: the call is its body


@pytest.fixture(scope="module")
def jax_det_steps(tmp_path_factory):
    """test_torch_detection's JAX det train step, 3 steps in a child process
    with XLA capped at AVX: its initial parameters, metrics and final
    parameters (the .npz the child writes)."""
    import test_torch_detection as reference

    path = tmp_path_factory.mktemp("det_steps") / "det_steps.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip())
    run = subprocess.run([sys.executable, "-c", reference.REFERENCE, str(path),
                          str(reference.ROOT)], cwd=reference.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return reference, np.load(path)


def test_compiled_det_steps_match_jaxs_jitted_step(jax_det_steps, monkeypatch):
    """The compiled step (on the CPU, its body) from JAX's initial weights,
    each step fed JAX's draw of fold_in(PRNGKey(seed), step): every loss
    term and lr within 1e-4 relative, the parameters after 3 steps within
    1e-4 of their largest entry, as test_three_det_train_steps_match_jax
    holds them."""
    import jax

    from posecnn_torch.core.weights import params_from_jax

    reference, ref = jax_det_steps
    batches, _, pts, sym = reference.scene_inputs()
    cfg = cfg_from_dict({"network": "posecnn_det", "train": reference.TRAIN})
    model = PoseCNNDet(reference.C, **reference.KW)
    model.load_state_dict(params_from_jax({k[5:]: ref[k] for k in ref.files
                                           if k.startswith("init/")}), strict=True)
    noise = {}  # step → JAX's draw
    monkeypatch.setattr(ttrain, "det_noise_seed", lambda seed, step: step)
    monkeypatch.setattr(ttrain, "target_noise",
                        lambda n_anchors, n_rois, generator, device: noise[generator.initial_seed()])
    state = ttrain.create_train_state(cfg, model)
    step = ttrain.make_det_train_step(cfg, model, torch.from_numpy(pts), torch.from_numpy(sym))
    assert isinstance(step, ttrain.CompiledDetTrainStep)
    rng = jax.random.PRNGKey(cfg.rng_seed)
    for i, b in enumerate(batches):
        noise[i] = reference.target_uniforms(jax.random.fold_in(rng, i), model, b)
        got = step(state, tb(b))
        for k in ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box", "loss_pose", "loss", "lr"):
            np.testing.assert_allclose(float(got[k]), float(ref[f"step{i}/{k}"]), rtol=1e-4,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    final = params_from_jax({k[6:]: ref[k] for k in ref.files if k.startswith("final/")})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(), rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(final[name]).max())),
                                   err_msg=name)


def host_reads(monkeypatch):
    """Record, from now on, every host constant built (`torch.tensor`,
    `torch.as_tensor`) and every read of a tensor on the host (`item`,
    `tolist`, `cpu`, `numpy`, `bool`/`int`/`float`, an index by a 0-d
    integer tensor, which PyTorch reads on the host). Returns the list."""
    made = []

    def recording(name, fn):
        def call(*a, **k):
            made.append(name)
            return fn(*a, **k)
        return call

    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, recording(name, getattr(torch, name)))
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, recording(name, getattr(torch.Tensor, name)))
    getitem = torch.Tensor.__getitem__

    def indexed(self, index):
        parts = index if isinstance(index, tuple) else (index,)
        if any(isinstance(p, torch.Tensor) and p.dim() == 0 and not p.is_floating_point()
               for p in parts):
            made.append("0-d index")
        return getitem(self, index)

    monkeypatch.setattr(torch.Tensor, "__getitem__", indexed)
    return made


def test_det_constants_are_device_buffers_made_once(monkeypatch):
    """The RoI targets' box normalisation and the depth fit's log grid are
    the values the programs built per call before, made once, not
    inference tensors; after a first call, a det step, `det_infer` and
    `det_pose` build no host constant and read nothing on the host."""
    for values in ((0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2)):
        with torch.inference_mode():
            made = device_constant(values, "cpu")
        assert torch.equal(made, torch.tensor(values, dtype=torch.float32))
        assert not made.is_inference() and device_constant(list(values), "cpu") is made
    # log_depth_grid's formula as it ran per call before
    start, stop = (torch.log(torch.tensor(d, dtype=torch.float32)) for d in (0.1, 5.0))
    frac = torch.arange(63, dtype=torch.float32) / 63.0
    old = torch.exp(torch.cat([start * (1 - frac) + stop * frac, stop[None]]))
    grid = rpn.log_depth_grid(0.1, 5.0, 64, "cpu")
    assert torch.equal(grid, old) and rpn.log_depth_grid(0.1, 5.0, 64, "cpu") is grid

    batches, pts, sym = toy_data()
    step, state = port_step(pts, sym)
    step(state, tb(batches[0]))
    model = step.model
    infer = lambda data: test_net.det_infer(model, data, means=None, stds=None,  # noqa: E731
                                            bbox_reg=True, nms_threshold=0.3)
    data = tb(batches[1])["data"]
    pose_args = (torch.rand(5, 4) - 0.5, torch.tensor([[10.0, 12.0, 40.0, 50.0]] * 5),
                 torch.from_numpy(pts[[1, 2, 2, 3, 1]]), torch.tensor(
                     [[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]]))
    with torch.no_grad():
        infer(data)
        test_net.det_pose(*pose_args)
    made = host_reads(monkeypatch)
    metrics = step(state, tb(batches[1]))
    with torch.no_grad():
        hit = infer(data)[3]
        q, t = test_net.det_pose(*pose_args)
    assert made == []
    monkeypatch.undo()
    assert np.isfinite(float(metrics["loss"])) and hit.shape == (C - 1, KW["post_nms_topk"])
    assert torch.isfinite(q).all() and torch.isfinite(t).all()


def test_reseeded_noise_generator_draws_what_det_noise_generator_draws():
    g = torch.Generator()
    torch.rand(100, generator=g)  # a used stream
    for step in (0, 5, 119999):
        g.manual_seed(ttrain.det_noise_seed(7, step))
        fresh = ttrain.det_noise_generator(7, step, "cpu")
        assert torch.equal(torch.rand(300, generator=g), torch.rand(300, generator=fresh))
    # the first of the posecnn step's dropout words: one SeedSequence per (seed, step)
    assert ttrain.det_noise_seed(7, 5) == ttrain.dropout_seeds(7, 5)[0]


def test_detection_eval_through_the_compiled_wrappers_equals_the_eager_loop(tmp_path,
                                                                            monkeypatch):
    """`test_net`'s detection evaluation on the CPU, each call of its two
    compiled programs recorded, then every frame recomputed as the eager
    loop before the programs did it: the forward, decode and clip, the
    per-class NMS by the host scan (`greedy_keep`), the score gate, and
    the depth fit on the frame's N detections without padding. The
    detections' mask, scores, boxes, quaternions and translations equal
    bit for bit; padded rows are dropped."""
    calls = []

    class Recording:
        def __init__(self, fn):
            self.fn, self.programs = fn, {}

        def __call__(self, *args):
            out = self.fn(*args)
            calls.append((self.fn, args, out))
            return out

    monkeypatch.setattr(test_net, "compile_static", Recording)
    result = test_net.main(["--device", "cpu", "--num_images", "3", "--output", str(tmp_path),
                            *TOY])
    assert result["run"]["graphs"] == {"det_infer": 0, "det_pose": 0}
    assert result["run"]["detections"] > 0
    frames, checked = 0, 0
    while calls:
        fn, (data,), (scores, boxes, poses, hit) = calls.pop(0)
        model, kw = fn.args[0], fn.keywords
        with torch.no_grad():
            out = model(data)
            want_scores = torch.softmax(out.cls_logits, dim=-1)
            deltas = out.bbox_pred * kw["stds"] + kw["means"]
            want_boxes = clip_boxes(bbox_transform_inv(out.proposals.rois[:, 1:5], deltas), H,
                                    W).reshape(-1, C, 4)
            sup = box_suppression(want_boxes[:, 1:].transpose(0, 1), want_scores[:, 1:].t(),
                                  kw["nms_threshold"], out.proposals.valid)
            keep = greedy_keep(Suppression(*sup))
            want_hit = keep & (want_scores[:, 1:].t() > test_net.DET_SCORE_THRESH) & (
                out.proposals.valid)
        for got, want in ((scores, want_scores), (boxes, want_boxes),
                          (poses, out.poses_pred), (hit, want_hit)):
            assert torch.equal(got, want), frames
        frames += 1
        n = int(hit.sum())
        if not n:
            continue
        pose_fn, (q_rows, box_rows, pts_rows, k), (q, t) = calls.pop(0)
        assert pose_fn is test_net.det_pose and len(q_rows) == test_net.padded_rows(n) >= n
        cls_i, roi_i = torch.nonzero(hit, as_tuple=True)
        cls_i = cls_i + 1
        q_old = poses.reshape(-1, C, 4)[roi_i, cls_i]
        q_old = q_old / torch.clamp(torch.linalg.vector_norm(q_old, dim=1, keepdim=True),
                                    min=1e-12)
        t_old = rpn.estimate_translation_from_box(q_old, boxes[roi_i, cls_i], pts_rows[:n], k)
        assert torch.equal(q[:n], q_old) and torch.equal(t[:n], t_old), frames
        checked += n
    assert frames == 3 and checked == result["run"]["detections"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph and the scan kernel have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replayed_det_steps_equal_eager_steps_on_the_card(cuda):
    """5 consecutive compiled steps (the first the real step and the
    capture, then replays), each against three eager steps from the same
    state: the metrics bit for bit where the eager ones are; each gradient
    within the eager spread or 1e-2 of its largest entry from the nearest
    eager one (the RoI pool's and the proposals' backward add with
    atomics); the optimizer run eagerly on the compiled step's gradients
    gives its parameters and momentum traces bit for bit."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batches, pts, sym = toy_data()
    step, state = port_step(pts, sym, device=cuda)
    held = [tb(b, cuda) for b in batches]
    for i, batch in enumerate((held * 2)[:5]):
        at = bench.snapshot(step, state)
        eagers = []
        for _ in range(3):
            at()
            eagers.append(one_step(step, state, batch, eager=True))
        at()
        metrics, grads, after = one_step(step, state, batch, eager=False)
        if all(max_distance(e[0], eagers[0][0]) == 0.0 for e in eagers):
            assert max_distance(metrics, eagers[0][0]) == 0.0, i
        for j, g in enumerate(grads):
            ref = [e[1][j] for e in eagers]
            near = min(max_distance([g], [r]) for r in ref)
            spread = max(max_distance([a], [b]) for a in ref for b in ref)
            assert near <= max(spread, 1e-2 * float(ref[0].abs().max())), (i, j, near, spread)
        keep = bench.snapshot(step, state)
        at()
        for p, g in zip(step.model.parameters(), grads):
            p.grad = g.clone()
        state.opt.prepare()
        state.opt.descend()
        assert max_distance(state_of(step, state), after) == 0.0, i
        keep()
    (program,) = step.compiled.programs.values()
    assert program.launches == {"tile": 0, "flat": 0, "window": 0, "scan": 1}


@pytest.mark.cuda
def test_one_scan_launch_a_replayed_det_step_on_the_card(cuda):
    batches, pts, sym = toy_data()
    step, state = port_step(pts, sym, device=cuda)
    batch = tb(batches[0], cuda)
    _cuda.LAUNCHES.update(dict.fromkeys(_cuda.LAUNCHES, 0))
    step(state, batch)  # the real step (eager) and the capture
    assert _cuda.LAUNCHES == {"tile": 0, "flat": 0, "window": 0, "scan": 1}
    _cuda.reset_device_launches()
    for _ in range(3):
        step(state, batch)
    assert _cuda.LAUNCHES["scan"] == 1  # replays call no wrapper
    assert _cuda.device_launches() == {"tile": 0, "flat": 0, "window": 0, "scan": 3}


@pytest.mark.cuda
def test_detection_programs_replay_their_eager_bodies_on_the_card(cuda):
    """`det_infer` and `det_pose` as `compile_static` programs: three
    frames replay one infer graph, equal to the eager body bit for bit and
    launching the scan twice (the RPN's NMS, the per-class NMS); the depth fit at 3 and 5 rows (padded to 4
    and 8) replays one graph a padded size."""
    from posecnn_torch.utils.graph import compile_static

    batches, pts, _ = toy_data()
    model = PoseCNNDet(C, **KW)
    init_weights(model, 0)
    model = model.to(cuda).eval()
    fn = lambda data: test_net.det_infer(model, data, means=None, stds=None,  # noqa: E731
                                         bbox_reg=True, nms_threshold=0.3)
    infer = compile_static(fn)
    with torch.no_grad():
        for b in batches:
            data = tb(b, cuda)["data"]
            got = [t.clone() for t in infer(data)]
            for g, w in zip(got, fn(data)):
                assert torch.equal(g, w)
        pose = compile_static(test_net.det_pose)
        k = torch.tensor([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], device=cuda)
        for n in (3, 5, 3):
            rows = test_net.padded_rows(n)
            args = (torch.rand(rows, 4, device=cuda) - 0.5,
                    torch.tensor([[10.0, 12.0, 40.0, 50.0]] * rows, device=cuda),
                    torch.from_numpy(pts[np.arange(rows) % C]).to(cuda), k)
            for g, w in zip(pose(*args), test_net.det_pose(*args)):
                assert torch.equal(g, w)
    (program,) = infer.programs.values()
    assert program.launches == {"tile": 0, "flat": 0, "window": 0, "scan": 2}
    assert sorted(p.args[0].shape[0] for p in pose.programs.values()) == [4, 8]
