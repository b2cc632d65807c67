"""The port's compiled call (`posecnn_torch/utils/graph.compile_static`,
the counterpart of `jax.jit`) and the programs it compiles, on the CPU.

- NMS's parts: `per_class_suppression` (the suppression matrix) then
  `greedy_keep` (the host scan) equals `nms_per_class` as it was before
  the split, `nms_per_class` as it is (the scan `greedy_scan`, on the
  device on a card) and JAX's `nms_per_class`, bit for bit, on seeded
  RoIs with score ties, overlapping twins and invalid rows, and on the
  edges: tied scores, no valid row, several (batch, class) pairs, R = 1,
  R = 33.
- The signature: equal shapes share one program, a new object count or a
  changed static argument makes a new one; on the CPU the call is `fn`'s
  own, outputs and all; tensors on two devices are refused.
- The serving engine: its compiled entry (`infer_device`, eager on the
  CPU) and its eager body (`_compiled.fn`, the NMS inside) against JAX's
  serve engine at a tiny size, with the same weights.

The CUDA graphs themselves run only on a card: the `cuda` tests hold the
engine's graph to its eager body bit for bit at batch 1 and 2 on three
frames in a row, and compiled ICP to eager ICP (`python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_compiled.py`).
The JAX side is imported inside the tests that use it: the card's machine
has no JAX.
"""

from functools import partial

import numpy as np
import pytest
import torch

from posecnn_torch.cli import serve
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.ops.nms import greedy_keep, nms_per_class, per_class_suppression
from posecnn_torch.utils.bbox import box_iou
from posecnn_torch.utils.graph import compile_static, signature

torch.set_num_threads(1)
C, H, W = 4, 64, 96
TINY = {"compute_dtype": "float32", "train": {"num_units": 8, "fc_dim": 32},
        "test": {"hough_num_samples": 64}}
K = np.array([[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]], np.float32)


def nms_per_class_before(rois, threshold, valid):
    """`ops/nms.nms_per_class` as it was before the split, line for line."""
    n = rois.shape[0]
    order = torch.argsort(-torch.where(valid, rois[:, 6], float("-inf")), dim=-1, stable=True)
    sr = rois[order]
    key = sr[:, :2].long()
    same = (key[:, None, :] == key[None, :, :]).all(-1)
    later = torch.ones((n, n), dtype=torch.bool).triu(diagonal=1)
    kill = (same & (box_iou(sr[:, 2:6], sr[:, 2:6]) > threshold) & later).numpy()
    suppressed = ~valid[order].numpy()
    kept = np.zeros(n, bool)
    for i in range(n):
        if not suppressed[i]:
            kept[i] = True
            suppressed |= kill[i]
    return torch.zeros(n, dtype=torch.bool).scatter(0, order, torch.from_numpy(kept))


def seeded_rois(seed, n=32):
    """(n, 7) Hough RoIs over 2 images and 3 classes: scores on a coarse
    grid (ties), overlapping twins, and about a fifth of the rows invalid."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * 60
    wh = 8 + rng.rand(n, 2) * 30
    rois = np.concatenate([rng.randint(0, 2, (n, 1)), rng.randint(1, 4, (n, 1)), xy, xy + wh,
                           np.round(rng.rand(n, 1) * 4) / 4], 1).astype(np.float32)
    rois[6:10] = rois[5] + np.array([0, 0, 1, 1, 1, 1, 0], np.float32)
    return rois, rng.rand(n) > 0.2


EDGES = ("ties", "all_invalid", "pairs", "r1", "r33")


def edge_rois(name):
    """(rois (R, 7) float32 Hough format, valid (R,) bool) at one of the
    scan's edges, made from a seed."""
    rng = np.random.RandomState(EDGES.index(name))
    n = {"r1": 1, "r33": 33, "pairs": 48}.get(name, 24)
    xy = rng.rand(n, 2) * (10 if name == "pairs" else 40)
    wh = 10 + rng.rand(n, 2) * 20
    batch = rng.randint(0, 3 if name == "pairs" else 1, (n, 1))
    cls = rng.randint(1, 5 if name == "pairs" else 2, (n, 1))
    scores = np.round(rng.rand(n, 1) * 3) / 3 if name == "ties" else rng.rand(n, 1)
    rois = np.concatenate([batch, cls, xy, xy + wh, scores], 1).astype(np.float32)
    valid = rng.rand(n) > 0.2
    if name == "all_invalid":
        valid[:] = False
    return rois, valid


@pytest.mark.parametrize("case", [0, 1, 2, 3, 4, 5, *EDGES])
def test_nms_split_equals_nms_per_class_and_jax(case):
    import jax.numpy as jnp

    from posecnn_tpu.ops.nms import nms_per_class as jax_nms_per_class

    rois, valid = seeded_rois(case) if isinstance(case, int) else edge_rois(case)
    r, v = torch.from_numpy(rois), torch.from_numpy(valid)
    got = greedy_keep(per_class_suppression(r, 0.5, v))
    np.testing.assert_array_equal(got.numpy(), nms_per_class_before(r, 0.5, v).numpy())
    np.testing.assert_array_equal(got.numpy(), nms_per_class(r, 0.5, v).numpy())
    want = jax_nms_per_class(jnp.asarray(rois), 0.5, jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case not in ("all_invalid", "r1"):
        assert 0 < got.sum() < valid.sum()  # something kept, something suppressed


def test_signature_keys_shapes_and_static_arguments():
    def call(n, rot_perturb=0.0, dtype=torch.float32):
        return signature((torch.zeros(n, 4, dtype=dtype), torch.zeros(48, 64)),
                         {"num_iters": 8, "rot_perturb": rot_perturb})

    programs = {}
    for args in [(4,), (4,), (4,)]:
        programs.setdefault(call(*args), len(programs))
    assert len(programs) == 1  # the same shapes: one program
    programs.setdefault(call(5), len(programs))
    assert len(programs) == 2  # a new object count: a new program
    programs.setdefault(call(5, 0.25), len(programs))
    assert len(programs) == 3  # a changed static argument: a new program
    programs.setdefault(call(5, 0.25, torch.float64), len(programs))
    assert len(programs) == 4  # a new dtype: a new program
    # keyword order does not matter; tensor values do not count
    assert signature((torch.ones(4, 4),), {"a": 1, "b": 2}) == signature(
        (torch.zeros(4, 4),), {"b": 2, "a": 1})


def test_compiled_call_on_the_cpu_is_the_function():
    out = (torch.arange(3.0), {"x": torch.ones(2)})
    calls = []

    def fn(a, b, *, scale):
        calls.append((a, b, scale))
        return out

    compiled = compile_static(fn)
    a, b = torch.zeros(3), torch.zeros(2, 2)
    assert compiled(a, b, scale=2.0) is out
    assert calls == [(a, b, 2.0)] and compiled.programs == {}
    with pytest.raises(ValueError, match="no tensor argument"):
        compiled(1, 2, scale=3.0)


@pytest.mark.parametrize("where", ["args", "kwargs"])
def test_compiled_call_refuses_tensors_on_two_devices(where):
    compiled = compile_static(lambda *a, **kw: None)
    host, other = torch.zeros(3), torch.zeros(3, device="meta")
    call = (lambda: compiled(host, other)) if where == "args" else (
        lambda: compiled(host, x=other))
    with pytest.raises(ValueError, match="more than one device: cpu, meta"):
        call()
    assert compiled.programs == {}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """JAX's serve engine at a tiny size, on c2f Hough, and the port's
    engines at batch 1 and 2 on the CPU with its weights."""
    from posecnn_tpu import models as jax_models
    from posecnn_tpu.cli import serve as jax_serve
    from posecnn_tpu.core.checkpoint import save_params as jax_save_params
    from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict

    path = str(tmp_path_factory.mktemp("serve") / "snap.npz")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_models, "PoseCNN", partial(jax_models.PoseCNN, hough_backend="pallas_c2f"))
    rng = np.random.RandomState(0)
    points = (rng.rand(C, 32, 3).astype(np.float32) - 0.5) * 0.12
    extents = np.abs(points).max(1) * 2
    try:
        jax_engines = {b: jax_serve.InferenceEngine(jax_cfg_from_dict(TINY), C, points, extents,
                                                    np.zeros(C), K, height=H, width=W, batch=b)
                       for b in (1, 2)}
    finally:
        mp.undo()
    jax_save_params(path, jax_engines[1]._params)
    port = {b: serve.InferenceEngine(cfg_from_dict(TINY), C, points, extents, np.zeros(C), K,
                                     height=H, width=W, ckpt=path, batch=b, device="cpu")
            for b in (1, 2)}
    return jax_engines, port


def frames(batch, seed):
    """Three canvases in a row: random, a bright block on zeros, zeros."""
    rng = np.random.RandomState(seed)
    block = np.zeros((batch, H, W, 3), np.uint8)
    block[:, 16:48, 24:72] = rng.randint(100, 255, (batch, 1, 1, 3))
    return [rng.randint(0, 255, (batch, H, W, 3)).astype(np.uint8), block,
            np.zeros((batch, H, W, 3), np.uint8)]


@pytest.mark.parametrize("batch", [1, 2])
def test_engine_compiled_and_eager_equal_jaxs_engine(engines, batch):
    import jax.numpy as jnp

    jax_engines, port = engines
    jax_engine, engine = jax_engines[batch], port[batch]
    live = 0
    for canvas in frames(batch, batch):
        meta = engine._meta0
        want = [np.asarray(a) for a in jax_engine._infer(jax_engine._params, jnp.asarray(canvas),
                                                         jnp.asarray(meta))]
        args = (torch.from_numpy(canvas), torch.from_numpy(meta))
        for entry in (engine.infer_device, partial(eager, engine)):
            label, rois, poses_init, poses_pred, keep = (a.numpy() for a in entry(*args))
            np.testing.assert_array_equal(label, want[0])
            np.testing.assert_allclose(rois, want[1], rtol=1e-5, atol=1e-3)
            np.testing.assert_allclose(poses_init, want[2], rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(poses_pred, want[3], atol=1e-4)
            np.testing.assert_array_equal(keep, want[4])
        live += int(keep.sum())
    assert live > 0, "no frame gave a detection to compare"


def eager(engine, data, meta):
    """The engine's body run eagerly, its NMS inside: what `infer_device`
    computes."""
    return engine._compiled.fn(data, meta)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def exact(got, want):
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
def test_engine_graph_equals_eager_on_the_card(cuda, batch):
    rng = np.random.RandomState(0)
    points = (rng.rand(C, 32, 3).astype(np.float32) - 0.5) * 0.12
    engine = serve.InferenceEngine(cfg_from_dict(TINY), C, points, np.abs(points).max(1) * 2,
                                   np.zeros(C), K, height=H, width=W, batch=batch, device=cuda)
    meta = torch.from_numpy(engine._meta0).to(cuda)
    for canvas in frames(batch, 7):
        data = torch.from_numpy(canvas).to(cuda)
        got = [a.clone() for a in engine.infer_device(data, meta)]
        want = eager(engine, data, meta)
        for name, g, w in zip(("label_2d", "rois", "poses_init", "poses_pred", "keep"), got,
                              want):
            assert exact(g, w), name
    (program,) = engine._compiled.programs.values()
    assert program.launches == {"tile": 0, "flat": 1, "window": 1, "scan": 1, "kabsch": 0,
                                "pose_hyp": 0, "pose_refine": 0}


@pytest.mark.cuda
def test_compiled_icp_equals_eager_on_the_card(cuda):
    from posecnn_torch.cli import test_icp
    from posecnn_torch.refine.icp import icp_refine_batch

    args = test_icp.make_parser().parse_args(["--set", "train.num_classes=6",
                                              "train.syn_height=96", "train.syn_width=128"])
    scenes = test_icp.perturbed_scenes(test_icp.load_config(args), 3, 8.0, 0.03)
    refine = compile_static(icp_refine_batch)
    for rp in (0.0, 0.25):
        for scene in scenes:
            inputs = test_icp.scene_inputs(scene, cuda)
            got = [f.clone() for f in refine(*inputs, num_iters=8, rot_perturb=rp)]
            want = refine.fn(*inputs, num_iters=8, rot_perturb=rp)
            for g, w in zip(got, want):
                assert exact(g, w)
    counts = {(len(s["gt"]), rp) for s in scenes for rp in (0.0, 0.25)}
    assert len(refine.programs) == len(counts)


@pytest.mark.cuda
def test_kernels_count_their_launches_and_graph_replays_on_the_card(cuda):
    from posecnn_torch.ops import hough_kernels as hk

    rng = np.random.RandomState(0)
    samples = torch.from_numpy(rng.uniform(0, 64, (2, 8, 32)).astype(np.float32)).to(cuda)
    bboxes = torch.tensor([[0.0, 64.0, 0.0, 48.0]] * 2, device=cuda)
    flat = compile_static(partial(hk.hough_votes_flat, cell_stride=4, grid_h=12, grid_w=16))
    hk.LAUNCHES["flat"] = 0
    hk.reset_device_launches()
    for _ in range(3):
        flat(samples, bboxes)
    (program,) = flat.programs.values()
    assert program.launches["flat"] == 1
    assert hk.LAUNCHES["flat"] == 1  # the warm-up: the three calls replay
    assert hk.device_launches()["flat"] == 4  # the warm-up and three replays
