"""YCB-Video class list and symmetry flags
(`posecnn_tpu/data/datasets.py:28-43`). The dataset readers are not
ported yet."""

from __future__ import annotations

import numpy as np

YCB_CLASSES = (
    "__background__",
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
    "011_banana", "019_pitcher_base", "021_bleach_cleanser", "024_bowl",
    "025_mug", "035_power_drill", "036_wood_block", "037_scissors",
    "040_large_marker", "051_large_clamp", "052_extra_large_clamp",
    "061_foam_brick",
)

YCB_SYMMETRY = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1],
    np.float32,
)
