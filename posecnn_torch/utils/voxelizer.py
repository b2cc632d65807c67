"""Scene voxel-grid bookkeeping (the port's copy of `posecnn_tpu/utils/voxelizer.py`).

The grid over a scene's bound (ref: lib/utils/voxelizer.py:12-208): set
from a bound or from a depth map's backprojected cloud plus a margin,
voxel ↔ world transforms, and the (step, min) pair that the 48-float meta
blob carries at meta[42:48].
"""

from __future__ import annotations

import numpy as np


class Voxelizer:
    def __init__(self, grid_size: int = 256, margin: float = 0.3):
        self.grid_size = grid_size
        self.margin = margin
        self.min_x = self.min_y = self.min_z = 0.0
        self.max_x = self.max_y = self.max_z = 0.0
        self.step_x = self.step_y = self.step_z = 0.0

    def setup(self, min_xyz, max_xyz):
        """Fix the grid over a scene bound (ref: voxelizer.setup)."""
        self.min_x, self.min_y, self.min_z = min_xyz
        self.max_x, self.max_y, self.max_z = max_xyz
        self.step_x = (self.max_x - self.min_x) / self.grid_size
        self.step_y = (self.max_y - self.min_y) / self.grid_size
        self.step_z = (self.max_z - self.min_z) / self.grid_size

    def setup_from_depth(self, depth: np.ndarray, k: np.ndarray):
        """Bound the grid by the backprojected depth cloud and the margin
        (ref: voxelizer.voxelize); an empty depth map gives [−1, 1]² × [0, 2]."""
        ys, xs = np.nonzero(depth > 1e-6)
        if len(ys) == 0:
            self.setup((-1, -1, 0), (1, 1, 2))
            return
        z = depth[ys, xs]
        x = (xs - k[0, 2]) / k[0, 0] * z
        y = (ys - k[1, 2]) / k[1, 1] * z
        m = self.margin
        self.setup((x.min() - m, y.min() - m, z.min() - m),
                   (x.max() + m, y.max() + m, z.max() + m))

    def voxel_to_world(self, ijk: np.ndarray) -> np.ndarray:
        steps = np.array([self.step_x, self.step_y, self.step_z])
        mins = np.array([self.min_x, self.min_y, self.min_z])
        return ijk * steps + mins

    def world_to_voxel(self, xyz: np.ndarray) -> np.ndarray:
        steps = np.array([self.step_x, self.step_y, self.step_z])
        mins = np.array([self.min_x, self.min_y, self.min_z])
        return np.floor((xyz - mins) / np.maximum(steps, 1e-10)).astype(np.int64)

    def meta_fields(self):
        """(step, min) tuples for the meta blob (meta[42:48])."""
        return ((self.step_x, self.step_y, self.step_z), (self.min_x, self.min_y, self.min_z))
