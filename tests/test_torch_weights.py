"""Port parity: the weight bridge (JAX .npz checkpoint → torch state_dict)
and the port's copy of the config tree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.core import checkpoint as jckpt
from posecnn_tpu.core import config as jcfg
from posecnn_tpu.models import PoseCNN as JaxPoseCNN
from posecnn_torch.cli.common import head_flags_from_ckpt
from posecnn_torch.core import config as tcfg
from posecnn_torch.core.weights import load_jax_checkpoint, load_npz, params_from_jax, read_ckpt_meta
from posecnn_torch.models.posecnn import PoseCNN

torch.set_num_threads(1)
C, UNITS, FC = 4, 16, 32


@pytest.fixture(scope="module")
def jax_params():
    """Flax PoseCNN parameters at a tiny width (a 32×32 input is enough:
    no parameter shape depends on the image size)."""
    model = JaxPoseCNN(num_classes=C, num_units=UNITS, fc_dim=FC, hough_num_samples=8,
                       max_objects=2, hough_backend="xla", compute_dtype=jnp.float32)
    meta = np.zeros((1, 48), np.float32)
    meta[0, [0, 4, 2, 5, 8]] = [50.0, 50.0, 16.0, 16.0, 1.0]
    init = jax.jit(lambda key: model.init(key, jnp.zeros((1, 32, 32, 3)), jnp.full((C, 3), 0.1),
                                          jnp.asarray(meta), train=False))
    return init(jax.random.PRNGKey(0))


@pytest.fixture
def ckpt(tmp_path, jax_params):
    path = str(tmp_path / "snap.npz")
    jckpt.save_params(path, jax_params, step=7,
                      meta={"norm_features": False, "quat_activation": "tanh",
                            "pose_pool_size": 7})
    return path


def test_every_key_maps_and_shapes_match(ckpt):
    flat = load_npz(ckpt)
    assert all(k.startswith("params/") for k in flat)
    state = params_from_jax(flat)
    model = PoseCNN(C, num_units=UNITS, fc_dim=FC)
    own = model.state_dict()
    assert set(state) == set(own)
    for name, tensor in state.items():
        assert tuple(tensor.shape) == tuple(own[name].shape), name
    load_jax_checkpoint(model, ckpt)
    # conv HWIO → OIHW and dense (in, out) → (out, in)
    k11 = flat["params/VGG16Trunk_0/conv1_1/kernel"]
    np.testing.assert_array_equal(model.trunk.conv1_1.weight.detach().numpy(),
                                  k11.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.pose_head.fc6.weight.detach().numpy(),
                                  flat["params/pose_head/fc6/kernel"].T)
    np.testing.assert_array_equal(model.vertex_head.vertex_out.bias.detach().numpy(),
                                  flat["params/vertex_head/vertex_out/bias"])


def test_unmapped_or_missing_keys_raise(ckpt):
    flat = load_npz(ckpt)
    with pytest.raises(KeyError):
        params_from_jax({**flat, "params/FeatureDiscriminator_0/fc1/kernel":
                         np.zeros((2, 2), np.float32)})
    # the domain head's keys map; a model built without the head refuses them
    state = params_from_jax({**flat, "params/domain_head/fc9/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="domain_head.fc9.weight"):
        PoseCNN(C, num_units=UNITS, fc_dim=FC).load_state_dict(state, strict=True)
    state = params_from_jax({k: v for k, v in flat.items() if "fc7" not in k})
    with pytest.raises(RuntimeError, match="fc7"):
        PoseCNN(C, num_units=UNITS, fc_dim=FC).load_state_dict(state, strict=True)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_jax_checkpoint(PoseCNN(C, num_units=UNITS, fc_dim=2 * FC), ckpt)


def test_ckpt_meta_and_head_flags_match_jax(ckpt):
    assert read_ckpt_meta(ckpt) == jckpt.read_ckpt_meta(ckpt)
    flags = head_flags_from_ckpt(tcfg.Config(), ckpt)
    assert flags == {"norm_features": False, "quat_activation": "tanh", "pose_pool_size": 7}
    assert head_flags_from_ckpt(tcfg.Config(), None)["norm_features"] is True


def test_config_tree_equals_jax_config():
    assert tcfg.cfg_to_dict(tcfg.Config()) == jcfg.cfg_to_dict(jcfg.Config())
    over = {"train": {"fc_dim": 64, "num_units": 16}, "test": {"hough_num_samples": 32}}
    assert (tcfg.cfg_to_dict(tcfg.cfg_from_dict(over))
            == jcfg.cfg_to_dict(jcfg.cfg_from_dict(over)))
    names = lambda mod: {f.name: f.type for f in dataclasses.fields(mod.Config)}
    assert names(tcfg) == names(jcfg)
    with pytest.raises(KeyError):
        tcfg.cfg_from_dict({"train": {"no_such_key": 1}})
