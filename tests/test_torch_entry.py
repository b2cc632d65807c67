"""Port parity: `posecnn_torch/entry.py` against `__graft_entry__.py`.

`make_inputs` equals `_make_inputs` bit for bit; the model `entry()`
builds has every field of the model JAX's `entry()` closes over; and its
forward at full size (22 classes, 480×640, cell stride 4) on JAX's own
parameters equals JAX's forward to `test_torch_posecnn.py::test_end_to_end`'s
tolerances. Both sides run in fp32 there: the JAX model is cloned with
`compute_dtype=float32` and `hough_backend="pallas_c2f"` (JAX's "auto" is
the dense reduction off the TPU; the port's is c2f everywhere), as that
test builds it. Without a card `entry()` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from posecnn_tpu.core.checkpoint import _flatten
from posecnn_tpu.models import PoseCNN as JaxPoseCNN
from posecnn_torch import entry as port_entry
from posecnn_torch.models import posecnn as posecnn_module
from posecnn_torch.models.posecnn import resolve_hough_backend

torch.set_num_threads(1)


@pytest.mark.parametrize("batch,height,width,with_gt", [
    (1, 48, 64, False), (1, 48, 64, True), (2, 48, 64, True), (2, 64, 96, False),
    (1, 480, 640, False),
])
def test_make_inputs_equals_jax(batch, height, width, with_gt):
    want = graft._make_inputs(batch, height, width, 22, with_gt=with_gt)
    got = port_entry.make_inputs(batch, height, width, 22, with_gt=with_gt, device="cpu")
    assert set(got) == set(want)
    for key, value in want.items():
        value = np.asarray(value)
        assert got[key].numpy().dtype == value.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


@pytest.fixture(scope="module")
def jax_entry():
    """JAX's entry(): its fn, the PoseCNN its fn closes over, its params
    and inputs. Its `model.init` runs jitted (the same draws; eager it
    takes ~25 s at 480×640 on one CPU thread)."""
    init = JaxPoseCNN.init

    def jitted_init(self, key, *args, **kw):
        return jax.jit(lambda k, *a: init(self, k, *a, **kw))(key, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPoseCNN, "init", jitted_init)
        fn, (params, data, extents, meta) = graft.entry()
    (model,) = [c.cell_contents for c in fn.__closure__]
    return dict(fn=fn, model=model, params=params, args=(data, extents, meta))


def port_model_of(fn):
    (model,) = [c.cell_contents for c in fn.__closure__]
    return model


def test_entry_config_equals_jax(jax_entry):
    jm = jax_entry["model"]
    fn, args = port_entry.entry(device="cpu")
    pm = port_model_of(fn)
    hk = pm.hough_kw
    pairs = {
        "num_classes": pm.num_classes,
        "num_units": pm.seg_head.score_conv5.out_channels,
        "fc_dim": pm.pose_head.fc6.out_features,
        "vote_threshold": hk["vote_threshold"],
        "vote_percentage": hk["vote_percentage"],
        "skip_pixels": hk["skip_pixels"],
        "hough_num_samples": hk["num_samples"],
        "max_objects": hk["max_objects_per_image"],
        "hough_cell_stride": hk["cell_stride"],
        "max_pose_rois": pm.max_pose_rois,
        "gt_pose_rois": pm.gt_pose_rois,
        "pose_pool_size": pm.pose_pool_size,
        "norm_features": pm.pose_head.norm_features,
        "quat_activation": pm.pose_head.quat_activation,
        "input_format": pm.input_format,
        "vertex_reg": pm.vertex_head is not None,
        "pose_reg": pm.pose_head is not None,
        "adaptation": pm.domain_head is not None,
    }
    for field, got in pairs.items():
        assert getattr(jm, field) == got, field
    assert resolve_hough_backend(jm.hough_backend) == hk["backend"] == "c2f"
    assert jm.compute_dtype == jnp.bfloat16 and pm.trunk.compute_dtype == torch.bfloat16
    assert jm.hough_cell_stride == 4
    for got, want in zip(args, jax_entry["args"]):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_entry_forward_matches_jax(jax_entry, monkeypatch):
    jm = jax_entry["model"].clone(hough_backend="pallas_c2f", compute_dtype=jnp.float32)
    params = jax_entry["params"]
    want, state = jax.jit(lambda p, *a: jm.apply(
        p, *a, train=False, capture_intermediates=True, mutable=["intermediates"]))(
        params, *jax_entry["args"])
    fn = port_entry.forward_fn(port_entry.flagship_model(
        4, device="cpu", params=_flatten(params), compute_dtype=torch.float32))
    inp = port_entry.make_inputs(1, port_entry.HEIGHT, port_entry.WIDTH, port_entry.NUM_CLASSES,
                                 device="cpu")
    args = (inp["data"], inp["extents"], inp["meta"])
    label, rois, poses = fn(*args)
    assert (label.numpy() == np.asarray(want.label_2d)).mean() >= 0.999
    assert np.asarray(want.hough.valid).any(), "the entry inputs gave no detection to compare"
    if not (label.numpy() == np.asarray(want.label_2d)).all():
        # a near-tie in the argmax moves a box edge: vote on JAX's own
        # labels and 1/8 vertex map, as test_stage_hough does
        jax_label = torch.from_numpy(np.array(want.label_2d))
        jax_vertex = torch.from_numpy(np.array(
            state["intermediates"]["vertex_head"]["__call__"][0]))
        original = posecnn_module.hough_voting

        def on_jax_inputs(label, vertex, *a, **kw):
            return original(jax_label, jax_vertex, *a, **kw)

        monkeypatch.setattr(posecnn_module, "hough_voting", on_jax_inputs)
        _, rois, poses = fn(*args)
    np.testing.assert_allclose(rois.numpy(), np.asarray(want.hough.rois), atol=1e-3)
    np.testing.assert_allclose(poses.numpy(), np.asarray(want.poses_pred), atol=1e-3)


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_entry.entry(device=device)
