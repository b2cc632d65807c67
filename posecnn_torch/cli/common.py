"""Shared CLI plumbing (counterpart of `posecnn_tpu/cli/common.py:14-102`)."""

from __future__ import annotations

import argparse

import torch

from posecnn_torch.core.config import Config, cfg_from_dict, cfg_from_file


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", dest="cfg_file", default=None, help="config YAML (ref --cfg)")
    p.add_argument("--device", default="cuda",
                   help="torch device; the default 'cuda' fails when no card is present")
    p.add_argument(
        "--set",
        dest="set_cfgs",
        nargs="*",
        default=[],
        help="config overrides key=value (dots for nesting)",
    )
    return p


def load_config(args) -> Config:
    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    overrides: dict = {}
    for kv in args.set_cfgs:
        key, _, value = kv.partition("=")
        node = overrides
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        import yaml

        node[parts[-1]] = yaml.safe_load(value)
    if overrides:
        cfg = cfg_from_dict(overrides, base=cfg)
    return cfg


def setup_device(name: str) -> torch.device:
    """The torch device to run on, and the fp32 precision policy.

    Raises when a CUDA device is asked for and there is none: nothing
    falls back to the CPU. TF32 is switched off for both matmuls and
    cuDNN convolutions, so the fp32 parts of the model (fc8, Hough
    glue, and every conv on the CPU-parity path) run in full fp32; the
    bf16 compute of the trunk and heads does not depend on it."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def _coerce_flag(value, like):
    """A checkpoint flag as the type of the cfg default. Bools accept
    only bools or the strings 'True'/'False' (bool('False') is True)."""
    if isinstance(like, bool):
        if isinstance(value, str):
            if value not in ("True", "False"):
                raise ValueError(f"cannot read {value!r} as a bool")
            return value == "True"
        return bool(value)
    return type(like)(value)


def head_flags_from_ckpt(cfg, ckpt_path):
    """Pose-head flags for eval/serve, taken from the checkpoint's
    recorded metadata when present (they change the forward pass at
    identical parameter shapes), else from the cfg."""
    flags = {
        "norm_features": bool(cfg.train.norm_features),
        "quat_activation": str(cfg.train.quat_activation),
        "pose_pool_size": int(cfg.train.pose_pool_size),
    }
    if not ckpt_path:
        return flags
    from posecnn_torch.core.weights import read_ckpt_meta

    meta = read_ckpt_meta(ckpt_path)
    if not meta:
        print(
            "WARNING: checkpoint records no head metadata; trusting cfg head "
            f"flags {flags} — results are wrong if it was trained under others"
        )
        return flags
    for k, cur in flags.items():
        if k not in meta:
            continue
        v = _coerce_flag(meta[k], cur)
        if v != cur:
            print(f"checkpoint head flag {k}={v!r} overrides cfg {cur!r}")
        flags[k] = v
    return flags
