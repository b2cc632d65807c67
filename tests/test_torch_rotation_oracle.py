"""Port parity: `posecnn_torch/cli/eval_rotation_oracle.py` against
`experiments/eval_rotation_oracle.py`.

Both run on one fabricated YCB-Video tree (`data/fabricate.write_ycb_tree`:
the 22 classes' model clouds and extents) and one seeded JAX checkpoint,
with a small cfg (num_units 8, fc_dim 32, fp32 compute on both sides) at
`--scale 0.1` (64×48 scenes), 4 images, `--device cpu` and no background
pool. The summaries must have the same keys, classes and counts, and each
class's mean and median error must agree within 0.1°: the summary rounds
to 0.1°, so an error that sits on a rounding edge may land one step apart.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.core.checkpoint import save_params
from posecnn_tpu.models import PoseCNN as JaxPoseCNN
from posecnn_torch.cli import eval_rotation_oracle
from posecnn_torch.data.fabricate import write_ycb_tree

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = """compute_dtype: float32
train:
  num_classes: 22
  num_units: 8
  fc_dim: 32
  hough_num_samples: 32
  orient_paint: true
"""
DEG_TOL = 0.1  # one step of the summary's rounding


def jax_oracle_main():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_rotation_oracle", os.path.join(REPO, "experiments", "eval_rotation_oracle.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


@pytest.fixture(scope="module")
def oracle_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("oracle")
    tree = str(root / "ycb")
    write_ycb_tree(tree, sets=(("train", 1),), height=48, width=64)
    cfg = root / "oracle.yaml"
    cfg.write_text(CFG)
    model = JaxPoseCNN(num_classes=22, num_units=8, fc_dim=32, hough_num_samples=32,
                       max_objects=7, gt_pose_rois=True, compute_dtype=jnp.float32)
    rng = np.random.RandomState(5)
    data = jnp.asarray(rng.randn(1, 48, 64, 3).astype(np.float32))
    extents = jnp.full((22, 3), 0.1, jnp.float32)
    meta = jnp.zeros((1, 48), jnp.float32).at[0, 0].set(100.0).at[0, 4].set(100.0)
    gt = jnp.zeros((1, 13), jnp.float32).at[0, 1].set(1.0).at[0, 6].set(1.0).at[0, 12].set(1.0)
    params = jax.jit(lambda k: model.init(k, data, extents, meta, gt_poses=gt,
                                          gt_valid=jnp.ones((1,), bool), train=True,
                                          keep_prob=1.0))(jax.random.PRNGKey(3))
    ckpt = str(root / "seeded.npz")
    save_params(ckpt, params, step=17)
    return dict(tree=tree, cfg=str(cfg), ckpt=ckpt, out=root)


def argv(inputs, out):
    return ["--ckpt", inputs["ckpt"], "--data_root", inputs["tree"], "--cfg", inputs["cfg"],
            "--num_images", "4", "--seed", "4242", "--scale", "0.1", "--device", "cpu",
            "--backgrounds", "", "--out", out]


def test_oracle_summary_matches_jax(oracle_inputs, monkeypatch):
    jax_out = str(oracle_inputs["out"] / "jax.json")
    monkeypatch.setattr(sys, "argv", ["eval_rotation_oracle.py", *argv(oracle_inputs, jax_out)])
    jax_oracle_main()()
    with open(jax_out) as f:
        want = json.load(f)

    port_out = str(oracle_inputs["out"] / "port.json")
    eval_rotation_oracle.main(argv(oracle_inputs, port_out))
    with open(port_out) as f:
        got = json.load(f)

    assert set(got) == set(want)
    for key in ("metric", "ckpt_step", "num_images", "nonsym_classes", "nonsym_below_45deg"):
        assert got[key] == want[key], key
    assert got["ckpt_step"] == 17 and got["num_images"] == 4
    assert got["per_class"], "the scenes gave no GT row"
    assert set(got["per_class"]) == set(want["per_class"])
    for cls, row in want["per_class"].items():
        mine = got["per_class"][cls]
        for key in ("n", "symmetric", "metric"):
            assert mine[key] == row[key], (cls, key)
        for key in ("mean_deg", "median_deg"):
            assert abs(mine[key] - row[key]) <= DEG_TOL + 1e-9, (cls, key, mine[key], row[key])
    assert abs(got["nonsym_mean_deg"] - want["nonsym_mean_deg"]) <= DEG_TOL + 1e-9


def test_oracle_needs_a_data_root(oracle_inputs):
    with pytest.raises(SystemExit):
        eval_rotation_oracle.main(["--ckpt", oracle_inputs["ckpt"], "--device", "cpu"])


def test_oracle_on_cuda_without_a_card_raises(oracle_inputs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_rotation_oracle.main(["--ckpt", oracle_inputs["ckpt"], "--data_root",
                                   oracle_inputs["tree"], "--cfg", oracle_inputs["cfg"]])
