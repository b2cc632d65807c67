"""RANSAC, the fusion programs and the evaluator's pose errors compiled
(`utils/graph.compile_static`, the counterpart of their JAX `jax.jit`), the
in-place arguments they need, the Kabsch kernel's plain version, and
`bench scaling`, on the CPU at small sizes.

- `compile_static(fn, inplace=...)`: the names must be `fn`'s arguments;
  an in-place argument enters the signature by its tensors' shapes and
  dtypes, not their addresses; a program refuses a call whose in-place
  tensors are not the ones it was captured on (address, shape or dtype)
  and copies only the other arguments; on the CPU `fn` runs as it is, so
  a bound volume's updates persist across calls.
- `estimate_center` and `estimate_pose_3d` compiled equal the eager bodies
  bit for bit, and JAX's jitted estimators fed the same indices at
  tests/test_torch_ransac.py's bars; `draw_hypotheses` given the valid
  count draws what it draws without it, reading nothing from the device.
- `kabsch_rotation_plain` (the Kabsch kernel's plain version, the SVD and
  the reflection fix) gives JAX's `_kabsch` rotation within 1e-5 on random
  and near-degenerate covariances (three points, planar, nearly planar,
  two equal singular values, a reflection); `kabsch_rotation` on the CPU
  is the plain version.
- The evaluator's padded pose-error program (`pair_errors` at
  `padded_pairs` rows, a z-flip class among them) equals the unpadded
  eager call within 1e-6 relative, and JAX's `_pose_errors_one` with its
  flip retry pair by pair at tests/test_torch_evaluate.py's bars (1e-5),
  ADD-S at a pair of zero error within tests/test_torch_pose_error.py's
  5e-4 (the Gram formula's cancellation).
- `test_fusion` compiles its four programs (the volume bound in place
  where a program takes it) and its report equals the JAX CLI's at
  tests/test_torch_seg_cli.py's bars; `test_video` compiles `fuse_frame`
  and `track_camera` and keeps one volume for the run.
- After a first call no new program's body builds a host constant or
  reads a tensor on the host (a CUDA graph captures neither).
- `python -m posecnn_torch.bench scaling --device cpu --ranks 2` prints
  the JAX script's lines, all finite, and the mechanism's note.

The `cuda` tests hold each program's replays to its eager body on the
card, count no vote kernel or scan launch a replay on the device (the
two pose kernels once each a replay of `estimate_pose_3d`, the Kabsch
kernel none), and hold the Kabsch kernel to its plain version (`python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_refine_compiled.py`). JAX is
imported inside the tests that use it: the card's machine has none.
"""

import json
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

from posecnn_torch.cli import test_fusion, test_video
from posecnn_torch.engine import evaluate as tev
from posecnn_torch.ops import _cuda
from posecnn_torch.refine import fusion, ransac
from posecnn_torch.utils import graph
from posecnn_torch.utils.graph import compile_static
from posecnn_torch.utils.quaternion import quat_to_mat_np
from test_torch_det_compiled import host_reads

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_LAUNCH = dict.fromkeys(_cuda.KERNELS, 0)
G, C, H, W = 16, 3, 24, 32  # the small volume and frame of the program tests
FUSION_FLAGS = ["--grid_size", "48", "--num_steps", "3", "--set", "train.num_classes=4",
                "train.syn_height=96", "train.syn_width=128", "train.syn_tnear=0.4",
                "train.syn_tfar=0.9"]


def tree_equal(a, b) -> bool:
    la, lb = [], []
    for tree, out in ((a, la), (b, lb)):
        out.extend(t for t in (tree if isinstance(tree, tuple) else (tree,)))
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def small_volume(device="cpu"):
    return fusion.create_volume(G, C, origin=(-0.4, -0.3, 0.5), voxel_size=0.05, device=device)


def frame(device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    depth = 0.8 + 0.3 * torch.rand((H, W), generator=g)
    prob = torch.softmax(torch.randn((H, W, C), generator=g), -1)
    k = torch.tensor([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]])
    return [t.to(device) for t in (depth, prob, k, torch.eye(3, 4))]


# --- compile_static's in-place arguments ---


def test_inplace_names_must_be_arguments():
    with pytest.raises(ValueError, match="not arguments"):
        compile_static(fusion.fuse_frame, inplace=("volume",))
    assert compile_static(fusion.fuse_frame, inplace=("vol",)).inplace == ("vol",)


def test_inplace_signature_keys_shapes_not_addresses():
    a, b = small_volume(), small_volume()
    x = torch.zeros(3)
    assert graph.signature((a, x), {}, {0}) == graph.signature((b, x), {}, {0})
    other = fusion.create_volume(G + 1, C, origin=(0, 0, 0), voxel_size=0.05)
    assert graph.signature((a, x), {}, {0}) != graph.signature((other, x), {}, {0})
    assert graph.signature((x,), {"vol": a}, {"vol"}) == graph.signature((x,), {"vol": b},
                                                                          {"vol"})


def test_inplace_program_refuses_other_tensors_and_copies_the_rest():
    """A program's `load` (a later call of its signature) checks the bound
    tensors' addresses, shapes and dtypes and copies only the others."""
    vol, x = small_volume(), torch.arange(4.0)
    program = object.__new__(graph._Program)
    program.args, program.kwargs = [vol, torch.zeros(4)], {"y": torch.zeros(2)}
    program.bound = {0: [graph._layout(t) for t in vol]}
    before = [t.clone() for t in vol]
    program.load((vol, x), {"y": torch.ones(2)})
    assert torch.equal(program.args[1], x) and torch.equal(program.kwargs["y"], torch.ones(2))
    assert program.args[0] is vol and all(torch.equal(t, u) for t, u in zip(vol, before))
    for other in (small_volume(), vol._replace(tsdf=vol.tsdf.clone()),
                  vol._replace(weight=vol.weight.double())):
        with pytest.raises(ValueError, match="in-place argument 0"):
            program.load((other, x), {"y": torch.ones(2)})


def test_inplace_updates_persist_across_calls_on_the_cpu():
    """On the CPU the compiled fuse is the body itself: two calls update
    the one volume twice, as two eager calls update a twin."""
    depth, prob, k, pose = frame()
    vol, twin = small_volume(), small_volume()
    fuse = compile_static(fusion.fuse_frame, inplace=("vol",))
    for _ in range(2):
        out = fuse(vol, depth, prob, k, pose)
        fusion.fuse_frame(twin, depth, prob, k, pose)
        assert out is vol
    assert all(torch.equal(a, b) for a, b in zip(vol, twin))
    assert int((vol.weight == 2).sum()) > 0 and fuse.programs == {}


# --- RANSAC ---


def center_case(rng, n=256):
    true_c = np.array([80.0, 60.0])
    px = rng.rand(n, 2) * np.array([160, 120])
    d = true_c - px
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bad = rng.rand(n // 4, 2) - 0.5
    d[: n // 4] = bad / np.linalg.norm(bad, axis=1, keepdims=True)
    return px.astype(np.float32), d.astype(np.float32), np.ones(n, bool)


def pose_case(rng, n=300):
    q = rng.randn(4)
    r_true = quat_to_mat_np(q / np.linalg.norm(q))
    obj = ((rng.rand(n, 3) - 0.5) * 0.2).astype(np.float32)
    cam = obj @ r_true.T + np.array([0.1, -0.05, 0.9]) + rng.randn(n, 3) * 0.002
    cam[: n * 3 // 10] += rng.rand(n * 3 // 10, 3) * 0.5
    return obj, cam.astype(np.float32), np.ones(n, bool)


@pytest.mark.parametrize("estimator", ["center", "pose_3d"])
def test_ransac_programs_equal_eager_and_jax(rng, estimator):
    import jax
    import jax.numpy as jnp

    from posecnn_tpu.refine import ransac as jr
    from test_torch_ransac import jax_pairs, jax_triples

    key = jax.random.PRNGKey(7)
    if estimator == "center":
        px, d, valid = center_case(rng)
        args = (torch.from_numpy(px), torch.from_numpy(d), torch.from_numpy(valid),
                jax_pairs(jnp.asarray(valid), key, 64))
        want = jr.estimate_center(jnp.asarray(px), jnp.asarray(d), jnp.asarray(valid), key,
                                  num_hypotheses=64)
        fn, kw = ransac.estimate_center, {}
    else:
        obj, cam, valid = pose_case(rng)
        args = (torch.from_numpy(obj), torch.from_numpy(cam), torch.from_numpy(valid),
                jax_triples(jnp.asarray(valid), key, 256))
        want = jr.estimate_pose_3d(jnp.asarray(obj), jnp.asarray(cam), jnp.asarray(valid), key,
                                   num_hypotheses=256, inlier_threshold=0.01)
        fn, kw = ransac.estimate_pose_3d, {"inlier_threshold": 0.01}
    got = compile_static(fn)(*args, **kw)
    assert tree_equal(tuple(got), tuple(fn(*args, **kw)))
    assert float(got.inliers) == float(want.inliers)
    np.testing.assert_allclose(float(got.score), float(want.score), rtol=1e-6)
    if estimator == "center":
        np.testing.assert_allclose(got.center.numpy(), np.asarray(want.center), rtol=0, atol=1e-3)
    else:
        for g, w in ((got.rotation, want.rotation), (got.translation, want.translation)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_draw_with_the_count_draws_the_same_and_reads_nothing(monkeypatch):
    valid = torch.zeros(1024, dtype=torch.bool)
    valid[:300] = True
    want = ransac.draw_hypotheses(valid, 64, 2, torch.Generator().manual_seed(3))
    made = host_reads(monkeypatch)
    got = ransac.draw_hypotheses(valid, 64, 2, torch.Generator().manual_seed(3), n_valid=300)
    assert made == [] and torch.equal(got, want)
    assert bool(valid[got].all())


# --- the Kabsch kernel's plain version ---


def kabsch_points(case, rng):
    """(src, dst, w) of one Kabsch case: dst = R src + t, a little noise."""
    n = {"three": 3}.get(case, 40)
    src = rng.randn(n, 3)
    if case == "planar":
        src[:, 2] = 0.0
    elif case == "nearly_planar":
        src[:, 2] *= 1e-4
    elif case == "equal_pair":
        src = np.concatenate([np.eye(3)[:2], -np.eye(3)[:2], rng.randn(1, 3) * 1e-3]) * 0.1
    q = rng.randn(4)
    r = quat_to_mat_np(q / np.linalg.norm(q))
    dst = src @ r.T + np.array([0.1, 0.2, 0.9])
    if case == "reflection":
        dst[:, 0] *= -1  # no rotation fits: the reflection fix decides
    dst = dst + rng.randn(*dst.shape) * 1e-4
    w = rng.rand(len(src)) + 0.5
    return src.astype(np.float32), dst.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "three", "planar", "nearly_planar", "equal_pair",
                                  "reflection"])
def test_kabsch_plain_version_matches_jax(rng, case):
    import jax.numpy as jnp

    from posecnn_tpu.refine import ransac as jr

    src, dst, w = kabsch_points(case, rng)
    r_j, t_j = jr._kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    cov = ransac.weighted_covariance(*(torch.from_numpy(a) for a in (src, dst, w)))[0]
    r_t = ransac.kabsch_rotation_plain(cov)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0, atol=1e-5)
    r_k, t_k = ransac._kabsch(*(torch.from_numpy(a) for a in (src, dst, w)))
    assert torch.equal(r_k, r_t)
    np.testing.assert_allclose(t_k.numpy(), np.asarray(t_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(r_t.numpy()), 1.0, atol=1e-5)
    rot, sweeps = ransac.kabsch_rotation(cov, sweeps=True)
    assert torch.equal(rot, r_t) and sweeps is None


# --- the evaluator's pose errors ---


def pose_pairs(rng, classes):
    def quat():
        q = rng.randn(4).astype(np.float32)
        return q / np.linalg.norm(q)

    return [(int(c), quat(), (rng.randn(3) * 0.1 + [0, 0, 1]).astype(np.float32), quat(),
             (rng.randn(3) * 0.1 + [0, 0, 1]).astype(np.float32)) for c in classes]


def test_padded_pairs():
    assert [tev.padded_pairs(n) for n in (1, 5, 8, 9, 16, 17)] == [8, 8, 8, 16, 16, 32]


def test_padded_pose_errors_equal_unpadded_and_jax(rng):
    import jax.numpy as jnp

    from posecnn_tpu.engine import evaluate as jev

    c, p = 4, 48
    points = (rng.rand(c, p, 3).astype(np.float32) - 0.5) * 0.2
    k = np.array([[500.0, 0, 64], [0, 500.0, 48], [0, 0, 1]], np.float32)
    # the first pair's GT turned 180° about z: its flip retry wins
    pairs = pose_pairs(rng, (2, 1, 2, 3, 1))
    pairs[0] = (*pairs[0][:3], np.asarray(tev.quat_mul(torch.from_numpy(pairs[0][1]),
                                                       torch.from_numpy(tev._Z_FLIP))),
                pairs[0][2])
    ev = tev.PoseEvaluator(num_classes=c, points=points, extents=np.ones((c, 3), np.float32),
                           z_flip_classes=(2,), intrinsics=k)
    inputs = ev.pair_inputs(pairs)
    assert inputs[0].shape[0] == 8 and torch.equal(inputs[0][5:], inputs[0][4:5].expand(3, 4))
    got = ev._pair_errors(pairs)
    assert np.array_equal(got, tev.pair_errors(*inputs).numpy()[:5])
    unpadded = tev.pair_errors(*(t[:5] for t in inputs[:6]), *inputs[6:]).numpy()
    np.testing.assert_allclose(got, unpadded, rtol=1e-6, atol=0)
    assert got[0, 0] < 1e-6  # the flipped GT matched exactly
    ref = jev.PoseEvaluator(num_classes=c, points=points, extents=np.ones((c, 3), np.float32),
                            z_flip_classes=(2,), intrinsics=k)
    for cls, q_est, t_est, q_gt, t_gt in pairs:
        ref._record_pair(cls, q_est, t_est, q_gt, t_gt)
    rows = {}
    for i, (cls, *_) in enumerate(pairs):
        rows.setdefault(cls, []).append(got[i])
    for cls, errs in rows.items():
        want = np.stack([ref.errors_add[cls], ref.errors_adi[cls], ref.errors_rot[cls],
                         ref.errors_trans[cls], ref.errors_reproj[cls]], 1)
        got_c = np.stack(errs)
        others = [0, 2, 3, 4]
        np.testing.assert_allclose(got_c[:, others], want[:, others], rtol=1e-5, atol=1e-5)
        # ADD-S's Gram formula cancels to ~5e-4 m at zero error (utils/pose_error)
        np.testing.assert_allclose(got_c[:, 1], want[:, 1], rtol=1e-5, atol=5e-4)


# --- the fusion programs through the CLIs ---


def recording_compiles(monkeypatch, module):
    """Replace `module.compile_static` with a subclass that records each
    compiled program's function name, in-place names and calls."""
    made = []

    class Recording(compile_static):
        def __init__(self, fn, inplace=()):
            super().__init__(fn, inplace=inplace)
            self.calls = 0
            made.append(self)

        def __call__(self, *args, **kwargs):
            self.calls += 1
            return super().__call__(*args, **kwargs)

    monkeypatch.setattr(module, "compile_static", Recording)
    return made


def test_test_fusion_programs_match_jax(monkeypatch, tmp_path):
    from posecnn_tpu.cli import test_fusion as jax_test_fusion

    made = recording_compiles(monkeypatch, test_fusion)
    got = test_fusion.main(["--device", "cpu", "--output", str(tmp_path / "port"),
                            *FUSION_FLAGS])
    programs = {getattr(p.fn, "__name__"): (p.inplace, p.calls) for p in made}
    assert programs == {"fuse_frame": (("vol",), 3), "raycast": (("vol",), 5),
                        "track_camera": ((), 2), "extract_mesh": (("vol",), 1)}
    jax_test_fusion.main(["--output", str(tmp_path / "jax"), *FUSION_FLAGS])
    with open(tmp_path / "jax" / "fusion_report.json") as f:
        want = json.load(f)
    for key in ("num_steps", "ply_faces", "grid_size", "surface_points", "surface_classes",
                "mesh_triangles"):
        assert got[key] == want[key], key
    assert got["surface_points"] > 0 and got["mesh_triangles"] > 0
    for key, tol in (("raycast_depth_mae_m", 1e-5), ("raycast_fg_label_acc", 1e-5),
                     ("mesh_area_m2", 1e-6), ("tracking_trans_err_m", 1e-4),
                     ("tracking_rot_err_deg", 1e-2)):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol, err_msg=key)


def test_test_video_compiles_fusion_on_one_volume(monkeypatch, tmp_path):
    """`test_video` compiles its forward, `fuse_frame` (the volume bound in
    place) and `track_camera`, and fuses every sequence into one volume,
    cleared in place: two sequences give the run of each alone."""
    made = recording_compiles(monkeypatch, test_video)
    volumes = []
    original = fusion.create_volume

    def create(*args, **kwargs):
        volumes.append(original(*args, **kwargs))
        return volumes[-1]

    monkeypatch.setattr(test_video, "create_volume", create)
    flags = ["--device", "cpu", "--num_steps", "2", "--grid_size", "16", "--set",
             "train.num_classes=3", "train.syn_height=48", "train.syn_width=64",
             "train.num_units=8"]
    both = test_video.main([*flags, "--num_sequences", "2", "--output", str(tmp_path / "a")])
    programs = {getattr(getattr(p.fn, "func", p.fn), "__name__"): (p.inplace, p.calls)
                for p in made}
    assert programs == {"video_labels": ((), 2), "fuse_frame": (("vol",), 4),
                        "track_camera": ((), 2)} and len(volumes) == 1
    first = test_video.main([*flags, "--num_sequences", "1", "--output", str(tmp_path / "b")])
    strip = [{k: v for k, v in r.items() if k != "seconds"} for r in both + first]
    assert strip[0] == strip[2]


# --- no host work in the bodies ---


def program_calls():
    """Each new program on small inputs: name -> a call of its body."""
    rng = np.random.RandomState(0)
    px, d, valid = (torch.from_numpy(a) for a in center_case(rng, 64))
    pairs = ransac.draw_hypotheses(valid, 16, 2, torch.Generator().manual_seed(0), n_valid=64)
    obj, cam, valid3 = (torch.from_numpy(a) for a in pose_case(rng, 64))
    triples = ransac.draw_hypotheses(valid3, 16, 3, torch.Generator().manual_seed(0), n_valid=64)
    ev = tev.PoseEvaluator(num_classes=4, points=rng.rand(4, 16, 3).astype(np.float32),
                           extents=np.ones((4, 3), np.float32), z_flip_classes=(1,))
    inputs = ev.pair_inputs(pose_pairs(rng, (1, 2, 3)))
    depth, prob, k, pose = frame()
    vol = small_volume()
    fusion.fuse_frame(vol, depth, prob, k, pose)
    return {
        "estimate_center": lambda: ransac.estimate_center(px, d, valid, pairs),
        "estimate_pose_3d": lambda: ransac.estimate_pose_3d(obj, cam, valid3, triples),
        "pair_errors": lambda: tev.pair_errors(*inputs),
        "fuse_frame": lambda: fusion.fuse_frame(vol, depth, prob, k, pose),
        "raycast": lambda: fusion.raycast(vol, k, pose, height=H, width=W, num_steps=16),
        "track_camera": lambda: fusion.track_camera(depth + 0.01, depth, k, pose, num_iters=2),
        "extract_mesh": lambda: fusion.extract_mesh(vol, max_triangles=64),
    }


@pytest.mark.parametrize("name", ["estimate_center", "estimate_pose_3d", "pair_errors",
                                  "fuse_frame", "raycast", "track_camera", "extract_mesh"])
def test_program_bodies_read_nothing_on_the_host(monkeypatch, name):
    call = program_calls()[name]
    call()  # a first call makes the device constants
    made = host_reads(monkeypatch)
    call()
    assert made == [], made


# --- bench scaling ---


def test_bench_scaling_on_the_cpu():
    run = subprocess.run([sys.executable, "-m", "posecnn_torch.bench", "scaling", "--device",
                          "cpu", "--ranks", "2"], capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = [json.loads(line) for line in run.stdout.splitlines()]
    sizes = [line for line in lines if "s_per_iter" in line]
    assert [line["devices"] for line in sizes] == [1, 2]
    for line in sizes:
        assert {"devices", "s_per_iter", "images_per_s"} <= set(line)
        assert all(np.isfinite(line[k]) and line[k] > 0 for k in ("s_per_iter", "images_per_s"))
        assert np.isfinite(line["loss"]) and line["backend"] == "gloo"
    (eff,) = [line for line in lines if "weak_scaling_efficiency" in line]
    assert eff["devices"] == 2 and np.isfinite(eff["weak_scaling_efficiency"])
    assert lines[-1]["scaling"] == "mechanism"
    refused = subprocess.run([sys.executable, "-m", "posecnn_torch.bench", "infer", "--device",
                              "cpu"], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert refused.returncode == 2 and "no CPU mode" in refused.stderr


# --- on the card ---


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph and the Kabsch kernel have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_inplace_program_on_the_card(cuda):
    """The first call updates the volume once (the real call, then the
    capture, which runs nothing); replays update it in place; a call with
    another volume raises."""
    depth, prob, k, pose = frame(cuda)
    vol, twin = small_volume(cuda), small_volume(cuda)
    fuse = compile_static(fusion.fuse_frame, inplace=("vol",))
    for _ in range(3):
        fuse(vol, depth, prob, k, pose)
        fusion.fuse_frame(twin, depth, prob, k, pose)
        assert all(torch.equal(a, b) for a, b in zip(vol, twin))
    assert int((vol.weight == 3).sum()) > 0 and len(fuse.programs) == 1
    with pytest.raises(ValueError, match="in-place argument"):
        fuse(twin, depth, prob, k, pose)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["estimate_center", "estimate_pose_3d", "pair_errors",
                                  "raycast", "track_camera", "extract_mesh"])
def test_programs_replay_their_eager_bodies_on_the_card(cuda, name):
    """Three replays of each program equal its eager body bit for bit; they
    call no kernel wrapper, and on the device launch no vote kernel and no
    scan (`estimate_pose_3d` its two pose kernels once each a replay, and
    no Kabsch kernel)."""
    body, program = card_programs(cuda)[name]
    want = body()
    program()  # the first call: the eager run and the capture
    _cuda.reset_device_launches()
    calls = dict(_cuda.LAUNCHES)
    for _ in range(3):
        got = program()
        assert tree_equal(tuple(got) if isinstance(got, tuple) else got,
                          tuple(want) if isinstance(want, tuple) else want), name
    assert _cuda.LAUNCHES == calls
    assert _cuda.device_launches() == ({**NO_LAUNCH, "pose_hyp": 3, "pose_refine": 3}
                                       if name == "estimate_pose_3d" else NO_LAUNCH)


def card_programs(device):
    """name -> (the eager body's call, the compiled program's call) on the
    card, on the inputs of `program_calls`."""
    rng = np.random.RandomState(0)
    px, d, valid = (torch.from_numpy(a).to(device) for a in center_case(rng, 64))
    pairs = ransac.draw_hypotheses(valid, 16, 2, torch.Generator().manual_seed(0), n_valid=64)
    obj, cam, valid3 = (torch.from_numpy(a).to(device) for a in pose_case(rng, 64))
    triples = ransac.draw_hypotheses(valid3, 16, 3, torch.Generator().manual_seed(0), n_valid=64)
    ev = tev.PoseEvaluator(num_classes=4, points=rng.rand(4, 16, 3).astype(np.float32),
                           extents=np.ones((4, 3), np.float32), z_flip_classes=(1,),
                           device=str(device))
    inputs = ev.pair_inputs(pose_pairs(rng, (1, 2, 3)))
    depth, prob, k, pose = frame(device)
    vol = small_volume(device)
    fusion.fuse_frame(vol, depth, prob, k, pose)
    table = {
        "estimate_center": (ransac.estimate_center, (px, d, valid, pairs), {}, ()),
        "estimate_pose_3d": (ransac.estimate_pose_3d, (obj, cam, valid3, triples), {}, ()),
        "pair_errors": (tev.pair_errors, inputs, {}, ()),
        "raycast": (fusion.raycast, (vol, k, pose), dict(height=H, width=W, num_steps=16),
                    ("vol",)),
        "track_camera": (fusion.track_camera, (depth + 0.01, depth, k, pose),
                         dict(num_iters=2), ()),
        "extract_mesh": (fusion.extract_mesh, (vol,), dict(max_triangles=64), ("vol",)),
    }
    out = {}
    for name, (fn, args, kw, inplace) in table.items():
        compiled = compile_static(fn, inplace=inplace)
        out[name] = (partial(fn, *args, **kw), partial(compiled, *args, **kw))
    return out


@pytest.mark.cuda
def test_kabsch_kernel_matches_its_plain_version_on_the_card(cuda):
    """`kabsch_kernel` against `kabsch_rotation_plain` (the SVD on the
    card) on every case of the plain version's test and on 256 random
    covariances: R within 1e-4 where the singular values stand apart by
    1e-3 of the largest, trace(R·cov) within 1e-5 of their sum on all,
    R orthonormal with det 1; one launch a call, counted by the wrapper
    and on the device."""
    rng = np.random.RandomState(0)
    covs = [ransac.weighted_covariance(*(torch.from_numpy(a) for a in kabsch_points(c, rng)))[0]
            for c in ("random", "three", "planar", "nearly_planar", "equal_pair", "reflection")]
    cov = torch.cat([torch.stack(covs), torch.randn(256, 3, 3, generator=torch.Generator()
                                                    .manual_seed(0))]).to(cuda)
    _cuda.reset_device_launches()
    n0 = _cuda.LAUNCHES["kabsch"]
    got, sweeps = ransac.kabsch_rotation(cov, sweeps=True)
    assert _cuda.LAUNCHES["kabsch"] == n0 + 1 and _cuda.device_launches()["kabsch"] == 1
    want = ransac.kabsch_rotation_plain(cov)
    sv = torch.linalg.svdvals(cov.double())
    apart = torch.minimum(sv[:, 0] - sv[:, 1], sv[:, 1] - sv[:, 2]) > 1e-3 * sv[:, 0]
    assert int(apart.sum()) > 200
    assert float((got - want).abs().flatten(1).amax(1)[apart].max()) <= 1e-4
    trace = (torch.einsum("nij,nji->n", got.double(), cov.double())
             - torch.einsum("nij,nji->n", want.double(), cov.double())).abs()
    assert float((trace / sv.sum(1)).max()) <= 1e-5
    assert float((got @ got.transpose(1, 2) - torch.eye(3, device=cuda)).abs().max()) <= 1e-5
    assert float((torch.linalg.det(got.double()) - 1).abs().max()) <= 1e-5
    assert int(sweeps.min()) >= 1 and int(sweeps.max()) <= 16
