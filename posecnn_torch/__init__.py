"""posecnn_torch — the PyTorch/CUDA port of posecnn_tpu.

A second package beside `posecnn_tpu/` with the same module names, so
each part has an obvious counterpart. It imports `torch` and never
`jax`. Plain tensor code is PyTorch; each Pallas kernel of the JAX
package becomes a kernel written by hand for NVIDIA Hopper (`csrc/`),
built at first use and bound with ctypes (`ops/_cuda.py`).

Ported so far: the single-frame serving path (`cli/serve.py`) — VGG16
trunk, seg and vertex skip heads, Hough voting (single- and
multi-instance; coarse-to-fine, exhaustive and dense) with the three
CUDA vote kernels, RoI pooling, the pose head and NMS — the GPU
validation entry point (`cli/validate.py`), training and evaluation of
the posecnn, detection, segmentation (FCN8, ResNet50) and recurrent
video families (`cli/train_net.py`, `cli/test_net.py`,
`cli/test_video.py`), ICP, RANSAC and TSDF fusion (`refine/`), the demo
and the dataset readers. `ROADMAP.md` lists what is left.
"""

__version__ = "0.1.0"
