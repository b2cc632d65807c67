"""Port parity: the small names carried into ported modules, on the CPU.

`ops/losses.loss_quaternion`, `core/config.cfg_to_json` and
`get_output_dir`, and `models/vgg16.bilinear_upsample_kernel` (OIHW here,
HWIO in JAX) against the JAX package's; `--rand` accepted by every port
CLI, as by JAX's; `core/checkpoint.import_vgg16_npy` on a fabricated
Caffe-layout `vgg16.npy` (as JAX's `tests/test_core.py` makes one): the
loaded model, read back through `params_to_jax`, equals what JAX's import
makes of the same starting parameters, convs, fc6 and fc7 loaded, fc8 and
a reshaped layer skipped, with the same printed line; and `train_net
--pretrained` starts the model from the file.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.core import checkpoint as jckpt
from posecnn_tpu.core import config as jconfig
from posecnn_tpu.models.vgg16 import bilinear_upsample_kernel as jax_kernel
from posecnn_tpu.ops.losses import loss_quaternion as jax_loss_quaternion
from posecnn_torch.cli import train_net
from posecnn_torch.core import checkpoint as tckpt
from posecnn_torch.core import config as tconfig
from posecnn_torch.core.weights import params_to_jax
from posecnn_torch.models import PoseCNN
from posecnn_torch.models.posecnn import init_weights
from posecnn_torch.models.vgg16 import bilinear_upsample_kernel
from posecnn_torch.ops.losses import loss_quaternion

torch.set_num_threads(1)
CLIS = ("check_data", "demo", "export_coco", "probe_overfit", "render_poses", "serve",
        "test_fusion", "test_icp", "test_net", "test_synthesis", "test_video", "train_net",
        "validate")
REQUIRED = {"probe_overfit": ["--data_root", "x"], "render_poses": ["--results", "x"]}
YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments",
                    "cfgs", "lov_color_2d_pool_full.yaml")


def test_loss_quaternion_equals_jax():
    rng = np.random.RandomState(0)
    pred, target = rng.randn(6, 12).astype(np.float32), rng.randn(6, 12).astype(np.float32)
    weight = (rng.rand(6, 12) > 0.5).astype(np.float32)
    for w in (weight, np.zeros_like(weight)):
        got = loss_quaternion(*(torch.from_numpy(a) for a in (pred, target, w)))
        want = jax_loss_quaternion(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_cfg_to_json_and_output_dir_equal_jax(tmp_path):
    got = tconfig.cfg_from_file(YAML)
    want = jconfig.cfg_from_file(YAML)
    assert tconfig.cfg_to_json(got) == jconfig.cfg_to_json(want)
    assert json.loads(tconfig.cfg_to_json(got))["train"]["fc_dim"] == 4096
    path = tconfig.get_output_dir(got, "lov_train", root=str(tmp_path))
    assert path == jconfig.get_output_dir(want, "lov_train", root=str(tmp_path))
    assert os.path.isdir(path) and path.endswith(os.path.join(got.exp_dir, "lov_train"))


@pytest.mark.parametrize("factor,channels", [(2, 3), (8, 5), (3, 2)])
def test_bilinear_upsample_kernel_equals_jax(factor, channels):
    got = bilinear_upsample_kernel(factor, channels).numpy()
    want = np.asarray(jax_kernel(factor, channels))
    assert got.shape == (channels, channels, 2 * factor, 2 * factor)
    np.testing.assert_array_equal(got, want.transpose(3, 2, 0, 1))  # HWIO → OIHW


@pytest.mark.parametrize("name", CLIS)
def test_every_cli_accepts_rand(name):
    parser = importlib.import_module(f"posecnn_torch.cli.{name}").make_parser()
    args = parser.parse_args(["--rand", *REQUIRED.get(name, [])])
    assert args.rand is True
    assert parser.parse_args(REQUIRED.get(name, [])).rand is False


def caffe_npy(path, fc_dim, rng):
    """A Caffe-layout vgg16.npy: conv1_1, conv1_2 and conv5_3 at VGG16's
    shapes, conv2_1 at a wrong one, fc6 (25088, fc_dim), fc7, fc8 (fc_dim,
    1000) and an entry without weights."""
    data = {}
    for name, (cin, cout) in (("conv1_1", (3, 64)), ("conv1_2", (64, 64)),
                              ("conv5_3", (512, 512)), ("conv2_1", (32, 128))):
        data[name] = {"weights": rng.randn(3, 3, cin, cout).astype(np.float32),
                      "biases": rng.randn(cout).astype(np.float32)}
    data["fc6"] = {"weights": rng.randn(7 * 7 * 512, fc_dim).astype(np.float32),
                   "biases": rng.randn(fc_dim).astype(np.float32)}
    data["fc7"] = {"weights": rng.randn(fc_dim, fc_dim).astype(np.float32),
                   "biases": rng.randn(fc_dim).astype(np.float32)}
    data["fc8"] = {"weights": rng.randn(fc_dim, 1000).astype(np.float32),
                   "biases": rng.randn(1000).astype(np.float32)}
    data["prob"] = {}
    np.save(path, data, allow_pickle=True)
    return data


def nested(flat):
    """Flat `params/a/b/kernel` keys as the flax tree JAX's import walks."""
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def test_import_vgg16_npy_equals_jax(tmp_path, capsys):
    fc_dim = 32
    npy = str(tmp_path / "vgg16.npy")
    data = caffe_npy(npy, fc_dim, np.random.RandomState(0))
    model = PoseCNN(3, num_units=8, fc_dim=fc_dim)
    init_weights(model, 0)
    before = params_to_jax(model.state_dict())
    assert tckpt.import_vgg16_npy(npy, model) == 5
    got_line = capsys.readouterr().out
    want_tree = jckpt.import_vgg16_npy(npy, nested(before))
    want_line = capsys.readouterr().out
    assert got_line == want_line
    assert "loaded 5 kernels (conv1_1, conv1_2, conv5_3, fc6, fc7)" in got_line
    got = params_to_jax(model.state_dict())
    want = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(want_tree)}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # loaded in torch layout: OIHW convs, (out, in) Linear weights
    np.testing.assert_array_equal(model.trunk.conv1_1.weight.detach().numpy(),
                                  data["conv1_1"]["weights"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.pose_head.fc6.weight.detach().numpy(),
                                  data["fc6"]["weights"].T)
    np.testing.assert_array_equal(model.pose_head.fc7.bias.detach().numpy(),
                                  data["fc7"]["biases"])
    for key in ("params/VGG16Trunk_0/conv2_1/kernel", "params/pose_head/fc8/kernel",
                "params/pose_head/fc8/bias", "params/seg_head/score_conv4/kernel"):
        np.testing.assert_array_equal(got[key], before[key], err_msg=key)


def test_train_net_pretrained_starts_from_the_npy(tmp_path):
    npy = str(tmp_path / "vgg16.npy")
    data = caffe_npy(npy, 64, np.random.RandomState(1))
    args = train_net.make_parser().parse_args([
        "--device", "cpu", "--rand", "--pretrained", npy, "--output", str(tmp_path / "out"),
        "--set", "train.syn_height=48", "train.syn_width=64", "train.num_classes=4",
        "train.fc_dim=64", "train.num_units=8", "train.ims_per_batch=1",
        "train.vertex_reg_2d=True", "train.pose_reg=True"])
    tr = train_net.build_trainer(args, train_net.load_config(args))
    tr.batches.close()
    np.testing.assert_array_equal(tr.model.trunk.conv5_3.bias.detach().numpy(),
                                  data["conv5_3"]["biases"])
    np.testing.assert_array_equal(tr.model.pose_head.fc6.weight.detach().numpy(),
                                  data["fc6"]["weights"].T)
    assert not np.array_equal(tr.model.pose_head.fc8.weight.detach().numpy().T[:, :4],
                              data["fc8"]["weights"][:, :4])
