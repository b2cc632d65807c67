"""Weight bridge between JAX `.npz` checkpoints and the port's `state_dict`.

Counterpart of `posecnn_tpu/core/checkpoint.py:25-62`. `save_params`
there writes one flat `.npz` whose parameter keys are
`params/<module>/<name>` (flax layout), plus `__step__` and
`__meta_<flag>__` entries. This module reads that file with numpy
alone and maps each parameter onto the port's module names:

  params/VGG16Trunk_0/convS_I/{kernel,bias}  → trunk.convS_I.{weight,bias}
  params/seg_head/score_conv{4,5,out}/…      → seg_head.score_conv{4,5,out}.…
  params/vertex_head/vertex_conv{4,5,out}/…  → vertex_head.vertex_conv{4,5,out}.…
  params/pose_head/fc{6,7,8}/…               → pose_head.fc{6,7,8}.…
  params/domain_head/{fc9,domain_score}/…    → domain_head.{fc9,domain_score}.…

and the detection model's (`PoseCNNDet`), whose trunk is named `trunk`
and whose heads are one level deep:

  params/trunk/convS_I/{kernel,bias}         → trunk.convS_I.{weight,bias}
  params/rpn_{conv,cls_score,bbox_pred}/…    → rpn_….{weight,bias}
  params/{fc6,fc7,cls_score,bbox_pred,pose_pred}/… → ….{weight,bias}

The segmentation and video families keep the JAX module names at any
depth (`FCN8`'s `score_fr`, `ResNet50Seg`'s
`params/trunk/stage2_block1/conv1/kernel`, `RecurrentSegNet`'s `fusion/gate`
and `GRU3DCell`'s `gate`): the path maps to the torch module path
segment for segment. So do the GAN models' (`models/gan.py`:
`FeatureDiscriminator`'s `conv1`, `conv2`, `logit`; the DCGAN pair's
`project`, `deconv1-3`, `norm1-3`, `deconv_out`, `conv1-4`); a flax
`ConvTranspose` kernel (HWIO, not flipped) maps as a conv kernel, and the
port's module flips it at the call.

A model built with `vertex_reg` or `pose_reg` off has no `vertex_head`,
`pose_head` or `domain_head` parameters, and neither has the JAX model's
tree: the key sets stay equal both ways.

The RGBD model has the same keys, with 1024 input channels in the heads'
conv4/conv5 kernels and p·p·1024 rows in fc6 (and in fc9 with adaptation).

Conv kernels go from flax's HWIO to torch's OIHW (DHWIO to OIDHW for 3-D
convs); Dense kernels from (in, out) to Linear's (out, in); a GroupNorm's
`scale` is its torch `weight` (the only 1-D weight in the port's models).
Convs without a bias have no `bias` entry on either side. fc6's rows need
no permutation: the port flattens the pooled (R, p, p, C) features in the
same NHWC order as the JAX pose head (`posecnn_tpu/models/posecnn.py:134`),
and the detection head's fc6 likewise (`posecnn_tpu/models/detection.py:146`).
`params_to_jax` is the inverse map, which `core/checkpoint.save_params`
writes; the model's `JAX_TRUNK` names its trunk there.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_MODULE_NAMES = {"VGG16Trunk_0": "trunk", "seg_head": "seg_head",
                 "vertex_head": "vertex_head", "pose_head": "pose_head",
                 "domain_head": "domain_head",
                 # PoseCNNDet
                 "trunk": "trunk", "rpn_conv": "rpn_conv", "rpn_cls_score": "rpn_cls_score",
                 "rpn_bbox_pred": "rpn_bbox_pred", "fc6": "fc6", "fc7": "fc7",
                 "cls_score": "cls_score", "bbox_pred": "bbox_pred", "pose_pred": "pose_pred",
                 # FCN8, ResNet50Seg, RecurrentSegNet and the fusion cells alone
                 "score_fr": "score_fr", "score_pool4": "score_pool4",
                 "score_pool5": "score_pool5", "score_c3": "score_c3", "score_c4": "score_c4",
                 "score": "score", "score_conv4": "score_conv4", "score_conv5": "score_conv5",
                 "fusion": "fusion", "gate": "gate", "gates": "gates",
                 "candidate": "candidate", "conv": "conv",
                 # the GAN models (FeatureDiscriminator, the DCGAN pair)
                 **{name: name for name in ("conv1", "conv2", "conv3", "conv4", "logit",
                                            "project", "deconv1", "deconv2", "deconv3",
                                            "deconv_out", "norm1", "norm2", "norm3")}}
FLAGSHIP_TRUNK = "VGG16Trunk_0"
# params/<module>[/<layer>…]/<kernel|bias|scale>
_KEY = re.compile(r"params/([^/]+)((?:/[^/]+)*)/(kernel|bias|scale)")
# flax kernel layout → torch weight layout, by rank
_TO_TORCH = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 2: (1, 0)}
_TO_JAX = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0), 2: (1, 0), 1: (0,)}


def load_npz(path: str) -> dict[str, np.ndarray]:
    """All parameter arrays of a `save_params` checkpoint, by flat key
    (the `__step__` / `__meta_*__` bookkeeping entries are left out)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return {k: data[k] for k in data.files if not k.startswith("__")}


def read_ckpt_meta(path: str) -> dict:
    """Forward-pass flags recorded by `save_params(meta=...)`; empty for
    checkpoints that predate them (`core/checkpoint.py:52-62`)."""
    out = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            m = re.fullmatch(r"__meta_(.+)__", key)
            if m:
                v = data[key]
                out[m.group(1)] = v.item() if v.ndim == 0 else v
    return out


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Map flat `params/<module>[/<name>…]/<kernel|bias|scale>` arrays to
    the port's `state_dict` keys. Raises on a key it cannot map; the
    caller's `load_state_dict(strict=True)` raises on one missing."""
    state = {}
    for key, value in flat.items():
        m = _KEY.fullmatch(key)
        if m is None or m.group(1) not in _MODULE_NAMES:
            raise KeyError(f"unmapped checkpoint key {key!r}")
        module, rest, kind = m.groups()
        arr = np.asarray(value, np.float32)
        if kind == "kernel":
            if arr.ndim not in (2, 4, 5):
                raise ValueError(f"{key}: unexpected kernel rank {arr.ndim}")
            arr = arr.transpose(_TO_TORCH[arr.ndim])
        path = _MODULE_NAMES[module] + rest.replace("/", ".")
        name = f"{path}.{'bias' if kind == 'bias' else 'weight'}"
        state[name] = torch.tensor(np.ascontiguousarray(arr))  # a contiguous copy
    return state


def params_to_jax(state: dict[str, torch.Tensor],
                  trunk: str = FLAGSHIP_TRUNK) -> dict[str, np.ndarray]:
    """The inverse of `params_from_jax`: a model's `state_dict` as flat
    `params/<module>[/<name>…]/<kernel|bias|scale>` fp32 arrays, conv
    kernels OI(D)HW → (D)HWIO, Linear weights (out, in) → (in, out), a
    GroupNorm's 1-D weight as `scale`; `trunk` is the trunk's JAX module
    name."""
    modules = {port: jax_name for jax_name, port in _MODULE_NAMES.items()}
    modules["trunk"] = trunk
    flat = {}
    for name, value in state.items():
        *path, kind = name.split(".")
        if path[0] not in modules or kind not in ("weight", "bias"):
            raise KeyError(f"state_dict key {name!r} has no place in a JAX checkpoint")
        arr = value.detach().cpu().float().numpy()
        leaf = "bias"
        if kind == "weight":
            arr = arr.transpose(_TO_JAX[arr.ndim])
            leaf = "scale" if arr.ndim == 1 else "kernel"
        key = "/".join(["params", modules[path[0]], *path[1:], leaf])
        flat[key] = np.ascontiguousarray(arr)
    return flat


def load_jax_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a JAX `.npz` checkpoint into `model` in place. Every
    parameter of the model must be in the file and every parameter of
    the file must land in the model, with equal shapes."""
    model.load_state_dict(params_from_jax(load_npz(path)), strict=True)
