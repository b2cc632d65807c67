"""Port parity: the carried augmentation (posecnn_torch.data.augment)
against posecnn_tpu.data.augment on the CPU.

Bit for bit: the HLS round trip, the chromatic jitter and both branches
of the noise model (Gaussian, motion blur) from the same `RandomState`
seed, and the state each leaves behind (the same draws in the same
order).
"""

import numpy as np
import pytest

from posecnn_tpu.data import augment as jaug
from posecnn_torch.data import augment as taug


def image(seed, h=24, w=31):
    return np.random.RandomState(seed).uniform(0, 255, (h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hls_round_trip_matches_jax(seed):
    im = image(seed)
    im[0, :4] = [[0, 0, 0], [255, 255, 255], [10, 10, 10], [200, 10, 10]]  # gray and pure hues
    hls = taug.bgr_to_hls(im)
    np.testing.assert_array_equal(hls, jaug.bgr_to_hls(im))
    np.testing.assert_array_equal(taug.hls_to_bgr(hls), jaug.hls_to_bgr(hls))
    np.testing.assert_allclose(taug.hls_to_bgr(hls), im, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_chromatic_transform_matches_jax(seed):
    im = image(seed)
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    got, want = taug.chromatic_transform(im, r1), jaug.chromatic_transform(im, r2)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, im)
    assert r1.rand() == r2.rand()


def seeds_of_each_noise_branch():
    """Seeds whose first draw picks the Gaussian branch, then ones that
    pick the motion blur (first draw ≥ 0.9) along each axis."""
    gauss = [s for s in range(50) if np.random.RandomState(s).rand() < 0.9][:2]
    blur = []
    for s in range(400):
        r = np.random.RandomState(s)
        if r.rand() >= 0.9:
            r.randint(6)
            blur.append((s, r.rand() < 0.5))
    return gauss + [next(s for s, ax in blur if ax), next(s for s, ax in blur if not ax)]


@pytest.mark.parametrize("seed", seeds_of_each_noise_branch())
def test_add_noise_matches_jax(seed):
    im = image(seed + 100)
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    got, want = taug.add_noise(im, r1), jaug.add_noise(im, r2)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, im)
    assert r1.rand() == r2.rand()


def test_explicit_jitter_amounts_draw_nothing():
    im = image(3)
    r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
    got = taug.chromatic_transform(im, r1, d_h=2.0, d_s=-10.0, d_l=5.0)
    want = jaug.chromatic_transform(im, r2, d_h=2.0, d_s=-10.0, d_l=5.0)
    np.testing.assert_array_equal(got, want)
    assert r1.rand() == np.random.RandomState(7).rand()
