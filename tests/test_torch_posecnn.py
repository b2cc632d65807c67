"""Port parity: the whole serving slice at a tiny size.

The port's PoseCNN forward on the CPU, in fp32, against the JAX
PoseCNN(hough_backend="pallas_c2f", compute_dtype=float32) with the same
weights through the bridge. Stage by stage, each port stage is fed the
JAX stage's input, so a near-tie in the label argmax cannot move a later
stage; then end to end. Then the port's HTTP server on the CPU, the
carried procedural library, and the import boundary (no jax).
"""

import base64
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.core.checkpoint import _flatten, save_params
from posecnn_tpu.data.procedural import synthetic_class_library as jax_library
from posecnn_tpu.models import PoseCNN as JaxPoseCNN
from posecnn_tpu.ops.roi_align import roi_pool_fused as jax_roi_pool
from posecnn_torch.cli import serve
from posecnn_torch.cli.common import setup_device
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.core.weights import params_from_jax
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.models.posecnn import PoseCNN, _eval_pose_weight
from posecnn_torch.ops.hough_voting import hough_voting
from posecnn_torch.ops.roi_align import roi_pool_fused

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, UNITS, FC, S, M = 4, 16, 32, 64, 4
H, W = 64, 96
TOL = dict(rtol=1e-4, atol=1e-4)


def inputs():
    rng = np.random.RandomState(0)
    data = (rng.randn(1, H, W, 3) * 60.0).astype(np.float32)
    extents = np.abs(rng.randn(C, 3)).astype(np.float32) * 0.1 + 0.05
    extents[0] = 0
    k = np.array([[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]], np.float32)
    meta = np.zeros((1, 48), np.float32)
    meta[0, :9] = k.flatten()
    meta[0, 9:18] = np.linalg.inv(k).flatten()
    return data, extents, meta


@pytest.fixture(scope="module")
def slice_run():
    """The JAX forward with its stage outputs, and the port's model with
    the same weights."""
    data, extents, meta = inputs()
    jmodel = JaxPoseCNN(num_classes=C, num_units=UNITS, fc_dim=FC, hough_num_samples=S,
                        max_objects=M, hough_backend="pallas_c2f", compute_dtype=jnp.float32)
    args = (jnp.asarray(data), jnp.asarray(extents), jnp.asarray(meta))
    params = jax.jit(lambda key: jmodel.init(key, *args, train=False))(jax.random.PRNGKey(0))
    out, state = jax.jit(lambda p: jmodel.apply(p, *args, train=False, capture_intermediates=True,
                                                mutable=["intermediates"]))(params)
    inter = state["intermediates"]
    conv4, conv5 = inter["VGG16Trunk_0"]["__call__"][0]
    model = PoseCNN(C, num_units=UNITS, fc_dim=FC, hough_num_samples=S, max_objects=M)
    model.load_state_dict(params_from_jax(_flatten(params)), strict=True)
    return dict(
        data=data, extents=extents, meta=meta, params=params, out=out, model=model,
        conv4=np.asarray(conv4), conv5=np.asarray(conv5),
        score=np.asarray(inter["seg_head"]["__call__"][0]),
        vertex_lr=np.asarray(inter["vertex_head"]["__call__"][0]),
    )


def t(a):
    return torch.from_numpy(np.array(a))


def test_stage_trunk(slice_run):
    r = slice_run
    with torch.inference_mode():
        conv4, conv5 = r["model"].trunk(t(r["data"]))
    np.testing.assert_allclose(conv4.numpy(), r["conv4"], **TOL)
    np.testing.assert_allclose(conv5.numpy(), r["conv5"], **TOL)


def test_stage_heads(slice_run):
    r = slice_run
    with torch.inference_mode():
        score = r["model"].seg_head(t(r["conv4"]), t(r["conv5"]))
        vertex = r["model"].vertex_head(t(r["conv4"]), t(r["conv5"]))
    np.testing.assert_allclose(score.numpy(), r["score"], **TOL)
    np.testing.assert_allclose(vertex.numpy(), r["vertex_lr"], **TOL)
    label = torch.argmax(score, dim=-1).numpy()
    assert (label == np.asarray(r["out"].label_2d)).mean() >= 0.999


def test_stage_hough(slice_run):
    r = slice_run
    jh = r["out"].hough
    got = hough_voting(t(r["out"].label_2d), t(r["vertex_lr"]), t(r["extents"]), t(r["meta"]),
                       num_samples=S, max_objects_per_image=M, vertex_factor=8)
    assert np.asarray(jh.valid).any(), "the tiny scene gave no detection to compare"
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(jh.valid))
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(jh.rois), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.poses_init.numpy(), np.asarray(jh.poses_init),
                               rtol=1e-5, atol=1e-5)


def test_stage_roi_pool_and_pose_head(slice_run):
    r = slice_run
    rois = np.asarray(r["out"].hough.rois)
    want_pooled = jax_roi_pool(jnp.asarray(r["conv4"]), jnp.asarray(r["conv5"]), jnp.asarray(rois))
    pooled = roi_pool_fused(t(r["conv4"]), t(r["conv5"]), t(rois))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), rtol=1e-5, atol=1e-5)
    hough = r["out"].hough._replace(rois=t(rois))
    with torch.inference_mode():
        pred, raw = r["model"].pose_head(t(want_pooled), _eval_pose_weight(hough, C))
    np.testing.assert_allclose(raw.numpy(), np.asarray(r["out"].poses_tanh), **TOL)
    np.testing.assert_allclose(pred.numpy(), np.asarray(r["out"].poses_pred), **TOL)


def test_end_to_end(slice_run):
    r = slice_run
    got = r["model"](t(r["data"]), t(r["extents"]), t(r["meta"]), full_vertex=True)
    want = r["out"]
    agree = (got.label_2d.numpy() == np.asarray(want.label_2d)).mean()
    assert agree >= 0.999
    np.testing.assert_allclose(got.log_prob.numpy(), np.asarray(want.log_prob), **TOL)
    np.testing.assert_allclose(got.prob.numpy(), np.asarray(want.prob), **TOL)
    np.testing.assert_allclose(got.vertex_pred.numpy(), np.asarray(want.vertex_pred), **TOL)
    if agree == 1.0:
        np.testing.assert_array_equal(got.hough.valid.numpy(), np.asarray(want.hough.valid))
        for name in ("rois", "poses_init"):
            np.testing.assert_allclose(getattr(got.hough, name).numpy(),
                                       np.asarray(getattr(want.hough, name)), atol=1e-3)
        np.testing.assert_allclose(got.poses_pred.numpy(), np.asarray(want.poses_pred), atol=1e-3)


def test_procedural_library_matches_jax():
    got, want = synthetic_class_library(22, 512), jax_library(22, 512)
    for name in ("points", "colors", "normals", "extents", "symmetry"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def tiny_engine(batch=1, ckpt=None, num_units=8):
    cfg = cfg_from_dict({"train": {"num_units": num_units, "fc_dim": FC},
                         "test": {"hough_num_samples": 32}})
    rng = np.random.RandomState(0)
    points = (rng.rand(C, 32, 3).astype(np.float32) - 0.5) * 0.12
    k = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]], np.float32)
    return serve.InferenceEngine(cfg, C, points, np.abs(points).max(1) * 2, np.zeros(C), k,
                                 height=48, width=64, ckpt=ckpt, batch=batch, device="cpu")


def post(url, payload):
    req = urllib.request.Request(url + "/infer", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def image_payload(img, **extra):
    return {"image_b64": base64.b64encode(img.tobytes()).decode(), "shape": list(img.shape),
            **extra}


def test_serve_answers_infer_over_http():
    engine = tiny_engine()
    srv = HTTPServer(("127.0.0.1", 0), serve.make_handler(engine))
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        assert json.loads(urllib.request.urlopen(url + "/healthz").read()) == {"ok": True}
        img = (np.random.RandomState(1).rand(48, 64, 3) * 255).astype(np.uint8)
        resp = post(url, image_payload(img))
        assert set(resp) == {"detections", "label_shape", "seconds", "batch_seconds",
                             "batch_size"}
        assert resp["label_shape"] == [48, 64]
        scores = [d["score"] for d in resp["detections"]]
        assert scores == sorted(scores, reverse=True)
        for det in resp["detections"]:
            assert set(det) == {"class", "class_name", "quat_wxyz", "trans", "roi", "score"}
            assert abs(np.linalg.norm(det["quat_wxyz"]) - 1.0) < 1e-4
        rle = post(url, image_payload(img, return_label=True))["label_rle"]
        assert sum(rle["counts"][1::2]) == 48 * 64
        with pytest.raises(urllib.error.HTTPError) as err:
            post(url, {"nope": 1})
        assert err.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)


def test_microbatched_serve_keeps_each_clients_frame():
    import concurrent.futures

    engine = tiny_engine(batch=2)
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              serve.make_handler(engine, serve.MicroBatcher(engine, 50.0)))
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        rng = np.random.RandomState(2)
        imgs = [(rng.rand(48, 64, 3) * 255).astype(np.uint8) for _ in range(2)]
        solo = [engine.infer_batch([im], [None])[0] for im in imgs]
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            got = list(ex.map(lambda im: post(url, image_payload(im)), imgs))
        for resp, ref in zip(got, solo):
            assert [d["class"] for d in resp["detections"]] == [d["class"] for d in ref["detections"]]
            for d, e in zip(resp["detections"], ref["detections"]):
                np.testing.assert_allclose(d["roi"], e["roi"], atol=1e-4)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)


def test_serve_loads_a_jax_checkpoint(slice_run, tmp_path):
    path = str(tmp_path / "snap.npz")
    save_params(path, slice_run["params"], meta={"quat_activation": "tanh"})
    engine = tiny_engine(ckpt=path, num_units=UNITS)
    assert engine.model.pose_head.quat_activation == "tanh"
    want = params_from_jax(_flatten(slice_run["params"]))
    for name, value in engine.model.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=0, atol=0)


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup_device("cuda")


def test_port_imports_no_jax():
    code = ("import sys, posecnn_torch, posecnn_torch.cli.serve, posecnn_torch.entry, "
            "posecnn_torch.utils.graph, posecnn_torch.bench, "
            "posecnn_torch.cli.eval_rotation_oracle, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'posecnn_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
