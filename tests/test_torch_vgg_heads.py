"""Port parity: VGG16 trunk, skip heads and the bilinear upsample against
the flax modules, in fp32, at sizes whose 1/8 and 1/16 maps are odd
(the max-pool "SAME" padding and the skip-head crop). Tolerance
rtol = atol = 1e-4: the two frameworks sum the convolutions in
different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.core.checkpoint import _flatten
from posecnn_tpu.models.posecnn import SkipHead as JaxSkipHead
from posecnn_tpu.models.vgg16 import VGG16Trunk as JaxTrunk
from posecnn_tpu.models.vgg16 import bilinear_upsample as jax_upsample
from posecnn_torch.core.weights import params_from_jax
from posecnn_torch.models.posecnn import SkipHead
from posecnn_torch.models.vgg16 import VGG16Trunk, bilinear_upsample

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def torch_state(params, jax_module_name):
    """A flax module's params as the state_dict of the torch module the
    bridge maps it to (prefix stripped)."""
    state = params_from_jax(_flatten({"params": {jax_module_name: params["params"]}}))
    return {k.split(".", 1)[1]: v for k, v in state.items()}


@pytest.mark.parametrize("hw", [(40, 56), (72, 88)])
def test_trunk_matches_jax(hw):
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32) * 50.0
    jtrunk = JaxTrunk(compute_dtype=jnp.float32)
    params = jax.jit(jtrunk.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    want4, want5 = jax.jit(jtrunk.apply)(params, jnp.asarray(x))
    trunk = VGG16Trunk()
    trunk.load_state_dict(torch_state(params, "VGG16Trunk_0"), strict=True)
    with torch.inference_mode():
        got4, got5 = trunk(torch.from_numpy(x))
    assert got4.shape == want4.shape and got5.shape == want5.shape
    assert got5.shape[1:3] == (-(-hw[0] // 16), -(-hw[1] // 16))
    np.testing.assert_allclose(got4.numpy(), np.asarray(want4), **TOL)
    np.testing.assert_allclose(got5.numpy(), np.asarray(want5), **TOL)


@pytest.mark.parametrize("relu, lowres, prefix", [(True, False, "score"),
                                                  (False, True, "vertex"),
                                                  (True, True, "score")])
def test_skip_head_matches_jax(relu, lowres, prefix):
    rng = np.random.RandomState(2)
    conv4 = rng.randn(2, 9, 11, 32).astype(np.float32)  # odd 1/8 map:
    conv5 = rng.randn(2, 5, 6, 32).astype(np.float32)  # ×2 up is cropped
    jhead = JaxSkipHead(8, 6, relu_scores=relu, name_prefix=prefix,
                        compute_dtype=jnp.float32, return_lowres=lowres)
    params = jhead.init(jax.random.PRNGKey(3), jnp.asarray(conv4), jnp.asarray(conv5), train=False)
    want = jhead.apply(params, jnp.asarray(conv4), jnp.asarray(conv5), train=False)
    head = SkipHead(32, 8, 6, relu_scores=relu, name_prefix=prefix, return_lowres=lowres)
    head.load_state_dict(torch_state(params, "seg_head"), strict=True)
    with torch.inference_mode():
        got = head(torch.from_numpy(conv4), torch.from_numpy(conv5))
    assert got.shape == want.shape == ((2, 9, 11, 6) if lowres else (2, 72, 88, 6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("factor", [2, 8])
def test_bilinear_upsample_matches_jax_resize(factor):
    x = np.random.RandomState(4).randn(2, 5, 7, 3).astype(np.float32)
    want = jax_upsample(jnp.asarray(x), factor)
    got = bilinear_upsample(torch.from_numpy(x), factor)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
