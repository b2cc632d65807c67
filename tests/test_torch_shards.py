"""Port parity: the offline shard store (`posecnn_torch/data/shards.py`)
against `posecnn_tpu/data/shards.py` on the CPU.

Both packages' generators render the same scenes (the same seed, class
library and camera, both through their C++ splats), so the shards each
`write_shards` writes hold the same arrays bit for bit, and the readers,
seeded alike, draw the same samples: the shard, the sample, the
background, the chromatic and the noise jitter, in order (the pattern of
JAX's `tests/test_shards.py`). The host stride over the file list is the
same too.
"""

import os

import numpy as np
import pytest
import torch

from posecnn_tpu.data.shards import ShardReader as JaxReader
from posecnn_tpu.data.shards import write_shards as jax_write
from posecnn_tpu.data.synthetic import SyntheticSceneGenerator as JaxGenerator
from posecnn_torch.data import ShardReader, write_shards
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator

torch.set_num_threads(1)
C, H, W = 4, 48, 64
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)


def generators():
    lib = synthetic_class_library(C, 256)
    kw = dict(width=W, height=H, seed=5, min_objects=1, max_objects=2, t_near=0.6, t_far=1.2,
              point_colors=lib.colors, point_normals=lib.normals)
    return (SyntheticSceneGenerator(lib.points, lib.extents, K, **kw),
            JaxGenerator(lib.points, lib.extents, K, **kw))


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    gen_t, gen_j = generators()
    got = write_shards(gen_t, str(root / "port"), num_samples=10, samples_per_shard=4)
    want = jax_write(gen_j, str(root / "jax"), num_samples=10, samples_per_shard=4)
    return root, got, want


def test_written_shards_equal_jax(shard_dirs):
    _, got, want = shard_dirs
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 3  # 4 + 4 + 2
    for g, w in zip(got, want):
        with np.load(g) as a, np.load(w) as b:
            assert a.files == b.files
            for key in b.files:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    with np.load(got[0]) as a:
        assert a["image"].dtype == np.float16 and a["depth"].dtype == np.float16
        assert a["label"].dtype == np.uint8 and a["poses"].shape == (4, 16, 13)


@pytest.mark.parametrize("chromatic,noise,with_bg", [(True, False, False), (False, True, True),
                                                     (True, True, True)])
def test_reader_draws_equal_jax(shard_dirs, chromatic, noise, with_bg):
    root, _, _ = shard_dirs
    means = np.array([102.9801, 115.9465, 122.7717], np.float32)
    bgs = (np.random.RandomState(1).randint(0, 255, (3, H, W, 3)).astype(np.uint8)
           if with_bg else None)
    kw = dict(seed=3, chromatic=chromatic, noise=noise, backgrounds=bgs)
    r_t = ShardReader(str(root / "port"), C, means, **kw)
    r_j = JaxReader(str(root / "jax"), C, means, **kw)
    for _ in range(6):
        got, want = r_t.sample(), r_j.sample()
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["image"].shape == (H, W, 3) and got["poses"].shape[1] == 13
    assert r_t.rng.rand() == r_j.rng.rand()


def test_background_replaces_the_empty_pixels(shard_dirs):
    root, _, _ = shard_dirs
    means = np.zeros(3, np.float32)
    reader = ShardReader(str(root / "port"), C, means, chromatic=False,
                         backgrounds=np.full((2, H, W, 3), 200, np.uint8))
    s = reader.sample()
    assert (s["label"] > 0).any()
    np.testing.assert_array_equal(s["image"][s["label"] == 0], 200.0)


def test_host_striding_equals_jax(tmp_path):
    gen_t, _ = generators()
    write_shards(gen_t, str(tmp_path), num_samples=8, samples_per_shard=2)
    means = np.zeros(3, np.float32)
    readers = []
    for index in range(3):
        kw = dict(process_index=index, process_count=3, seed=9)
        r_t, r_j = ShardReader(str(tmp_path), C, means, **kw), JaxReader(str(tmp_path), C,
                                                                         means, **kw)
        assert r_t.paths == r_j.paths
        for _ in range(2):  # seeded by seed + process_index, as JAX's
            got, want = r_t.sample(), r_j.sample()
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        readers.append(r_t)
    assert [len(r.paths) for r in readers] == [2, 1, 1]
    assert len({p for r in readers for p in r.paths}) == 4
    with pytest.raises(FileNotFoundError):
        ShardReader(str(tmp_path), C, means, process_index=5, process_count=6)
