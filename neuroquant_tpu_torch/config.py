"""YAML config loading (the counterpart of ``neuroquant_tpu/config.py``):
the reference's config surface, same keys, light validation."""

from __future__ import annotations

import yaml

_COMMON_KEYS = (
    "crop_h", "crop_w", "loss", "epoch", "eval_freq", "batch_size",
    "learning_rate",
)

_ARCH_KEYS = {
    "nerv": ("base", "level", "dec_in_channel", "dec_kernels", "dec_strides",
             "channel_reduce", "channel_lbound", "dec_norm", "dec_acts",
             "out_bias"),
    "hnerv": ("stage_block", "enc_strides", "enc_channel", "dec_in_channel",
              "dec_kernels", "dec_strides", "channel_reduce", "channel_lbound",
              "dec_norm", "dec_acts", "out_bias"),
    "pnerv": ("enc_channel", "emd_channel", "enc_strides", "kfc_h_w_c",
              "kfc_strides", "dec_norm", "dec_acts"),
}
# PNeRV1 and PNeRV2 share PNeRV's keys (the JAX package validates only the
# name 'pnerv', though its build_model and compress take all three)
_ARCH_KEYS["pnerv1"] = _ARCH_KEYS["pnerv2"] = _ARCH_KEYS["pnerv"]


def get_config(config_path: str) -> dict:
    """Load a YAML config into a plain dict."""
    with open(config_path, "r") as stream:
        return yaml.load(stream, Loader=yaml.FullLoader)


def validate_config(cfg: dict, arch: str) -> dict:
    """Check that `cfg` carries every key `arch` needs; returns cfg."""
    arch = arch.lower()
    if arch not in _ARCH_KEYS:
        raise ValueError(f"unknown arch {arch!r}; this port supports "
                         f"{sorted(_ARCH_KEYS)}")
    missing = [k for k in _COMMON_KEYS + _ARCH_KEYS[arch] if k not in cfg]
    if missing:
        raise KeyError(f"config missing keys for arch={arch}: {missing}")
    return cfg
