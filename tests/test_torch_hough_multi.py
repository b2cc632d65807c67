"""Port parity: the exhaustive vote and multi-instance Hough voting
(posecnn_torch) against the JAX package, on the scenes of
tests/test_hough_voting.py and tests/test_hough_pallas.py (120×160,
4 classes).

The JAX side runs its Pallas kernels in interpret mode. The port's plain
vote versions sum sample by sample with the kernels' arithmetic and
skips, so the votes are held to rtol 1e-5 with atol 0 (they agree to the
bit in practice), and the exhaustive and c2f backends to JAX "pallas"
and "pallas_c2f" row for row. The dense backend's chunked sums may
differ from the XLA path's in the last bit, which can move a plateau
maximum, so it is held to JAX "xla" as a set, with the plateau tolerance
of tests/test_hough_pallas.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jhp = importlib.import_module("posecnn_tpu.ops.hough_pallas")
jhv = importlib.import_module("posecnn_tpu.ops.hough_voting")
from posecnn_tpu.core.checkpoint import _flatten
from posecnn_tpu.models import PoseCNN as JaxPoseCNN
from posecnn_torch.cli import validate
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.core.weights import params_from_jax
from posecnn_torch.models.posecnn import PoseCNN, resolve_hough_backend
from posecnn_torch.ops import hough_kernels as thk
from posecnn_torch.ops import hough_voting as thv
from tests.test_hough_pallas import assert_multi_instance_parity
from tests.test_hough_voting import EXTENTS, H, W, make_meta, make_scene
from tests.test_torch_hough import SCENES, packed_inputs

torch.set_num_threads(1)

MULTI = {
    "same_class_pair": ([(1, 40.0, 60.0, 1.0, 18, 18), (1, 120.0, 60.0, 1.0, 18, 18)], 5.0),
    "close_13": ([(1, 40.0, 60.0, 1.0, 10, 10), (1, 53.0, 60.0, 1.0, 10, 10)], 5.0),
    "close_16": ([(1, 40.0, 60.0, 1.0, 10, 10), (1, 56.0, 60.0, 1.0, 10, 10)], 5.0),
    "close_19": ([(1, 40.0, 60.0, 1.0, 10, 10), (1, 59.0, 60.0, 1.0, 10, 10)], 5.0),
    "close_22": ([(1, 40.0, 60.0, 1.0, 10, 10), (1, 62.0, 60.0, 1.0, 10, 10)], 5.0),
    "mixed_corner": ([(1, 30.0, 40.0, 0.9, 16, 16), (1, 110.0, 90.0, 1.4, 20, 16),
                      (3, 8.0, 8.0, 1.1, 14, 14)], 4.0),
}
KW = dict(label_threshold=100, num_samples=128, max_classes=3, max_objects_per_image=4)
TO_JAX = {"exhaustive": "pallas", "c2f": "pallas_c2f", "dense": "xla"}


def run_both(objects, backend, vote_threshold, cell_stride=1):
    label, vert = make_scene(objects)
    kw = dict(KW, vote_threshold=vote_threshold, vote_percentage=1e-4, cell_stride=cell_stride)
    want = jhv.hough_voting(
        jnp.asarray(label[None]), jnp.asarray(vert[None]), jnp.asarray(EXTENTS),
        jnp.asarray(make_meta()[None]), backend=TO_JAX[backend], sample_chunk=8, **kw,
    )
    got = thv.hough_voting(
        torch.from_numpy(label[None]), torch.from_numpy(vert[None]), torch.from_numpy(EXTENTS),
        torch.from_numpy(make_meta()[None]), backend=backend, **kw,
    )
    return got, want


def assert_rows_match(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(want.rois), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.poses_init.numpy(), np.asarray(want.poses_init),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("name", ["single", "corner_three", "empty"])
def test_exhaustive_plain_matches_jax_pallas(name, stride):
    samples, bboxes = packed_inputs(name)
    kw = dict(cell_stride=stride, grid_h=H // stride, grid_w=W // stride)
    jv, jd = jhp.hough_votes_pallas(jnp.asarray(samples), jnp.asarray(bboxes), interpret=True,
                                    **kw)
    tv, td = thk.hough_votes_exhaustive(torch.from_numpy(samples), torch.from_numpy(bboxes), **kw)
    assert tv.shape == (samples.shape[0], H // stride, W // stride)
    if name != "empty":
        assert np.asarray(jv).max() > 0
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", ["two", "small_edge", "corner_three"])
def test_c2f_windows_greedy_pick_matches_jax(name):
    samples, bboxes = packed_inputs(name)
    kw = dict(cell_stride=1, grid_h=H, grid_w=W, top_t=32, coarse_local_max=True)
    want = jhp.hough_votes_c2f_windows(jnp.asarray(samples), jnp.asarray(bboxes),
                                       interpret=True, **kw)
    got = thk.hough_votes_c2f_windows(torch.from_numpy(samples), torch.from_numpy(bboxes), **kw)
    for g, w in zip(got[2:], want[2:]):  # origins and enable: exact
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[4].any()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["exhaustive", "c2f"])
@pytest.mark.parametrize("name", list(MULTI))
def test_multi_instance_matches_jax_row_for_row(name, backend):
    objects, threshold = MULTI[name]
    got, want = run_both(objects, backend, threshold)
    assert_rows_match(got, want)
    assert int(got.valid.sum()) >= len(objects)


@pytest.mark.parametrize("name", ["same_class_pair", "close_16", "mixed_corner"])
def test_multi_instance_dense_matches_jax_xla_as_a_set(name):
    objects, threshold = MULTI[name]
    got, want = run_both(objects, "dense", threshold)
    assert_multi_instance_parity(want, got)
    # every planted centre is found
    rois = got.rois[got.valid].numpy()
    cx, cy = (rois[:, 2] + rois[:, 4]) / 2, (rois[:, 3] + rois[:, 5]) / 2
    for _, x, y, *_ in objects:
        assert np.min(np.hypot(cx - x, cy - y)) <= 4.0


@pytest.mark.parametrize("name", ["single", "two", "corner_three", "empty"])
def test_single_instance_exhaustive_matches_jax_pallas(name):
    got, want = run_both(SCENES[name], "exhaustive", -1.0)
    assert_rows_match(got, want)


def test_multi_instance_cell_stride2_matches_jax():
    objects, threshold = MULTI["mixed_corner"]
    for backend in ("exhaustive", "c2f"):
        got, want = run_both(objects, backend, threshold, cell_stride=2)
        assert_rows_match(got, want)


def test_vote_percentage_filter_drops_sparse_maxima():
    objects, threshold = MULTI["same_class_pair"]
    label, vert = make_scene(objects)
    args = (torch.from_numpy(label[None]), torch.from_numpy(vert[None]),
            torch.from_numpy(EXTENTS), torch.from_numpy(make_meta()[None]))
    kept = thv.hough_voting(*args, **KW, vote_threshold=threshold, vote_percentage=1e-4,
                            backend="exhaustive")
    dropped = thv.hough_voting(*args, **KW, vote_threshold=threshold, vote_percentage=1e9,
                               backend="exhaustive")
    assert int(kept.valid.sum()) >= 2 and int(dropped.valid.sum()) == 0


C, UNITS, FC, S, M = 4, 16, 32, 64, 4
MH, MW = 64, 96


@pytest.fixture(scope="module")
def model_inputs():
    """The small config of tests/test_torch_posecnn.py, with a JAX init."""
    rng = np.random.RandomState(0)
    data = (rng.randn(1, MH, MW, 3) * 60.0).astype(np.float32)
    extents = np.abs(rng.randn(C, 3)).astype(np.float32) * 0.1 + 0.05
    extents[0] = 0
    k = np.array([[120.0, 0, MW / 2], [0, 120.0, MH / 2], [0, 0, 1]], np.float32)
    meta = np.zeros((1, 48), np.float32)
    meta[0, :9] = k.flatten()
    meta[0, 9:18] = np.linalg.inv(k).flatten()
    jmodel = JaxPoseCNN(num_classes=C, num_units=UNITS, fc_dim=FC, hough_num_samples=S,
                        max_objects=M, compute_dtype=jnp.float32)
    args = (jnp.asarray(data), jnp.asarray(extents), jnp.asarray(meta))
    params = jax.jit(lambda key: jmodel.init(key, *args, train=False))(jax.random.PRNGKey(0))
    return data, extents, meta, params


@pytest.mark.parametrize("jax_backend,vote_threshold", [("pallas", -1.0), ("pallas", 1.0),
                                                        ("pallas_c2f", 1.0)])
def test_posecnn_forward_matches_jax(model_inputs, jax_backend, vote_threshold):
    data, extents, meta, params = model_inputs
    hkw = dict(vote_threshold=vote_threshold, vote_percentage=1e-4, hough_backend=jax_backend)
    jmodel = JaxPoseCNN(num_classes=C, num_units=UNITS, fc_dim=FC, hough_num_samples=S,
                        max_objects=M, compute_dtype=jnp.float32, **hkw)
    args = (jnp.asarray(data), jnp.asarray(extents), jnp.asarray(meta))
    want = jax.jit(lambda p: jmodel.apply(p, *args, train=False))(params)
    model = PoseCNN(C, num_units=UNITS, fc_dim=FC, hough_num_samples=S, max_objects=M, **hkw)
    assert model.hough_kw["backend"] == resolve_hough_backend(jax_backend)
    model.load_state_dict(params_from_jax(_flatten(params)), strict=True)
    got = model(*(torch.from_numpy(a) for a in (data, extents, meta)))
    assert (got.label_2d.numpy() == np.asarray(want.label_2d)).mean() == 1.0
    assert np.asarray(want.hough.valid).any(), "the tiny scene gave no detection to compare"
    np.testing.assert_array_equal(got.hough.valid.numpy(), np.asarray(want.hough.valid))
    for name in ("rois", "poses_init"):
        np.testing.assert_allclose(getattr(got.hough, name).numpy(),
                                   np.asarray(getattr(want.hough, name)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.poses_pred.numpy(), np.asarray(want.poses_pred), atol=1e-3)


def test_hough_backend_names():
    assert [resolve_hough_backend(n) for n in ("auto", "pallas_c2f", "pallas", "xla")] == [
        "c2f", "c2f", "exhaustive", "dense"]
    assert [resolve_hough_backend(n) for n in thv.BACKENDS] == list(thv.BACKENDS)
    with pytest.raises(ValueError, match="hough backend"):
        resolve_hough_backend("triton")


def test_validate_checks_pass_on_the_cpu():
    """The validation entry point's checks at 120×160 with the plain
    vote versions (its chip run is at 480×640 with the kernels)."""
    cfg = cfg_from_dict({"train": {"num_units": 16, "fc_dim": 32},
                         "test": {"hough_num_samples": 64}})
    got = validate.run_checks(torch.device("cpu"), 120, 160, cfg=cfg)
    assert got["c2f_equals_exhaustive"] and got["multi_instance"]
    assert got["hough_detections"] > 0 and got["serving_forward"] == "ok"
    assert set(got["multi_instance_peak_votes"]) == set(thv.BACKENDS)
    assert got["multi_instance_hough_ms"] == dict.fromkeys(thv.BACKENDS, "not measured")
    # the training checks: a finite train-step loss, the ADD-loss probe
    # under 15°, and no card-vs-CPU gradient gap without a card
    assert np.isfinite(got["train_step_loss"]) and got["rot_probe_final_deg"] < 15.0
    assert got["probe_grad_card_vs_cpu"] == "not measured"


def test_validate_needs_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate.main(["--out", str(tmp_path / "v.json")])
