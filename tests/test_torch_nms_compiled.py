"""The per-class NMS inside the serving, demo and `test_net` programs, on
the CPU (`cli/common.forward_with_nms`: the PoseCNN forward and
`ops/nms.nms_per_class`, the suppression matrix then the greedy scan on
the device, as the JAX CLIs jit the forward with their `nms_per_class`).

- `forward_with_nms`'s keep mask equals the host scan (`greedy_keep`) over
  the forward's own suppression matrix, and the serving engine's keep
  (its compiled entry, eager on the CPU) equals JAX's jitted serve forward
  (`posecnn_tpu/cli/serve.py:96-106`) on seeded frames of a tiny model,
  one of them with live detections, with the same weights.
- After a first call the body builds no host constant and reads nothing on
  the host (a CUDA graph captures neither).

The scan kernel itself runs only on a card: `tests/test_torch_kernels.py`
holds it to its plain version at `chip_smoke.SCAN_CASES` (`-m cuda`), and
`tests/test_torch_compiled.py` holds the engine's graph, keep mask
included, to its eager body there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_torch.cli import serve
from posecnn_torch.cli.common import forward_with_nms
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.ops.nms import greedy_keep, per_class_suppression
from test_torch_det_compiled import host_reads

torch.set_num_threads(1)
C, H, W = 4, 64, 96
TINY = {"compute_dtype": "float32", "train": {"num_units": 8, "fc_dim": 32},
        "test": {"hough_num_samples": 64}}
K = np.array([[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """JAX's serve engine at batch 1 on c2f Hough (its `model.init` jitted,
    the rest as written) and the port's on the CPU with its weights."""
    from posecnn_tpu import models as jax_models
    from posecnn_tpu.cli import serve as jax_serve
    from posecnn_tpu.core.checkpoint import save_params as jax_save_params
    from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict

    real = jax_models.PoseCNN

    def jax_model(*args, **kwargs):
        model = real(*args, hough_backend="pallas_c2f", **kwargs)

        def init(rng, *a, **kw):
            return jax.jit(lambda r, *x: real.init(model, r, *x, **kw))(rng, *a)

        object.__setattr__(model, "init", init)  # the first call jitted, not op by op
        return model

    path = str(tmp_path_factory.mktemp("serve") / "snap.npz")
    rng = np.random.RandomState(0)
    points = (rng.rand(C, 32, 3).astype(np.float32) - 0.5) * 0.12
    extents = np.abs(points).max(1) * 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_models, "PoseCNN", jax_model)
        jax_engine = jax_serve.InferenceEngine(jax_cfg_from_dict(TINY), C, points, extents,
                                               np.zeros(C), K, height=H, width=W, batch=1)
    jax_save_params(path, jax_engine._params)
    port = serve.InferenceEngine(cfg_from_dict(TINY), C, points, extents, np.zeros(C), K,
                                 height=H, width=W, ckpt=path, batch=1, device="cpu")
    return jax_engine, port


def frames():
    """Canvases from a seed: random, a bright block on zeros, zeros."""
    rng = np.random.RandomState(1)
    block = np.zeros((1, H, W, 3), np.uint8)
    block[:, 16:48, 24:72] = rng.randint(100, 255, (1, 1, 1, 3))
    return [rng.randint(0, 255, (1, H, W, 3)).astype(np.uint8), block,
            np.zeros((1, H, W, 3), np.uint8)]


def test_forward_keep_equals_the_host_scan_and_jaxs_serve_forward(engines):
    jax_engine, engine = engines
    meta = torch.from_numpy(engine._meta0)
    live = 0
    for canvas in frames():
        data = torch.from_numpy(canvas)
        with torch.inference_mode():
            out, keep = forward_with_nms(engine.model, data.float() - engine._pixel_means,
                                         engine._extents, meta, engine.nms_threshold)
        host = greedy_keep(per_class_suppression(out.hough.rois, engine.nms_threshold,
                                                 out.hough.valid))
        assert keep.dtype == torch.bool and torch.equal(keep, host)
        *_, served = engine.infer_device(data, meta)
        want = jax_engine._infer(jax_engine._params, jnp.asarray(canvas),
                                 jnp.asarray(engine._meta0))
        np.testing.assert_array_equal(served.numpy(), np.asarray(want[4]))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(want[4]))
        live += int(keep.sum())
    assert live > 0, "no frame gave a detection to compare"


def test_forward_with_nms_reads_nothing_on_the_host(engines, monkeypatch):
    _, engine = engines
    args = (torch.from_numpy(frames()[1]), torch.from_numpy(engine._meta0))
    engine._compiled.fn(*args)  # a first call makes the device constants
    made = host_reads(monkeypatch)
    engine._compiled.fn(*args)
    assert made == [], made
