"""Offline synthetic-data shards: render once, stream at train time.

Counterpart of `posecnn_tpu/data/shards.py`. `write_shards` renders scenes
with a `SyntheticSceneGenerator` (through the C++ splats of
`data/native.py` by default) into `<out_dir>/shard_%06d.npz` files: the
raw BGR image and the depth as fp16, the label as uint8, the GT pose rows
padded to (16, 13) with their count, and the intrinsics. `ShardReader`
streams samples from them: process `process_index` of `process_count`
reads every `process_count`-th shard of the sorted list, and draws the
shard, the sample, the background and the chromatic and noise jitter of
`data/augment.py` from `RandomState(seed + process_index)` in the
original's order, so the same seed gives the same samples as the JAX
package's reader.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from posecnn_torch.data.augment import add_noise, chromatic_transform

MAX_POSES = 16  # pose rows kept a sample


def write_shards(gen, out_dir: str, num_samples: int, samples_per_shard: int = 64,
                 start_index: int = 0) -> list[str]:
    """Render `num_samples` scenes of `gen` into shards of
    `samples_per_shard`, named by the index of their first sample; returns
    the paths written."""
    os.makedirs(out_dir, exist_ok=True)
    idx = start_index
    written = []
    while idx < start_index + num_samples:
        n = min(samples_per_shard, start_index + num_samples - idx)
        fields = {"image": [], "label": [], "depth": [], "poses": [], "n_poses": []}
        for _ in range(n):
            s = gen.render()
            fields["image"].append(s.image + gen.pixel_means)  # stored raw
            fields["label"].append(s.label)
            fields["depth"].append(s.depth)
            padded = np.zeros((MAX_POSES, 13), np.float32)
            padded[: min(len(s.poses), MAX_POSES)] = s.poses[:MAX_POSES]
            fields["poses"].append(padded)
            fields["n_poses"].append(min(len(s.poses), MAX_POSES))
        path = os.path.join(out_dir, f"shard_{idx:06d}.npz")
        np.savez_compressed(
            path,
            image=np.stack(fields["image"]).astype(np.float16),
            label=np.stack(fields["label"]).astype(np.uint8),
            depth=np.stack(fields["depth"]).astype(np.float16),
            poses=np.stack(fields["poses"]),
            n_poses=np.asarray(fields["n_poses"], np.int32),
            meta=gen.k,
        )
        written.append(path)
        idx += n
    return written


class ShardReader:
    """Samples from the shards under `shard_dir` with background
    compositing and chromatic / noise augmentation, one host's stride of
    the shard list. `backgrounds` (N, H, W, 3) replaces the label-0 pixels."""

    def __init__(self, shard_dir: str, num_classes: int, pixel_means, seed: int = 0,
                 process_index: int = 0, process_count: int = 1, chromatic: bool = True,
                 noise: bool = False, backgrounds: Optional[np.ndarray] = None):
        self.paths = sorted(
            os.path.join(shard_dir, f) for f in os.listdir(shard_dir)
            if f.startswith("shard_") and f.endswith(".npz")
        )[process_index::process_count]
        if not self.paths:
            raise FileNotFoundError(f"no shards under {shard_dir}")
        self.num_classes = num_classes
        self.pixel_means = np.asarray(pixel_means, np.float32)
        self.rng = np.random.RandomState(seed + process_index)
        self.chromatic = chromatic
        self.noise = noise
        self.backgrounds = backgrounds
        self._cache_path: Optional[str] = None
        self._cache: Optional[dict] = None

    def _load(self, path: str) -> dict:
        """The arrays of one shard; the last shard read stays in memory."""
        if self._cache_path != path:
            with np.load(path) as data:
                self._cache = dict(data)
            self._cache_path = path
        return self._cache

    def sample(self) -> dict:
        """One sample: image (H, W, 3) fp32 mean-subtracted, label (H, W)
        int32, depth (H, W) fp32, its pose rows (n, 13) and the intrinsics."""
        data = self._load(self.paths[self.rng.randint(len(self.paths))])
        i = self.rng.randint(data["image"].shape[0])
        image = data["image"][i].astype(np.float32)
        label = data["label"][i].astype(np.int32)
        depth = data["depth"][i].astype(np.float32)
        poses = data["poses"][i][: data["n_poses"][i]]
        bg_mask = label == 0
        if self.backgrounds is not None and len(self.backgrounds):
            bg = self.backgrounds[self.rng.randint(len(self.backgrounds))]
            image[bg_mask] = bg[bg_mask].astype(np.float32)
        if self.chromatic:
            image = chromatic_transform(image, self.rng)
        if self.noise:
            image = add_noise(image, self.rng)
        return {"image": image - self.pixel_means, "label": label, "depth": depth,
                "poses": poses, "meta_k": data["meta"]}
