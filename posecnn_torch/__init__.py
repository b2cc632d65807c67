"""posecnn_torch — the PyTorch/CUDA port of posecnn_tpu.

A second package beside `posecnn_tpu/` with the same module names, so
each part has an obvious counterpart. It imports `torch` and never
`jax`. Plain tensor code is PyTorch; each Pallas kernel of the JAX
package becomes a kernel written by hand for NVIDIA Hopper (`csrc/`),
built at first use and bound with ctypes (`ops/_cuda.py`).

Ported so far: the single-frame serving path (`cli/serve.py`) — VGG16
trunk, seg and vertex skip heads, coarse-to-fine Hough voting with its
two CUDA vote kernels, RoI pooling, the pose head and NMS.
"""

__version__ = "0.1.0"
