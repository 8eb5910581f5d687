"""Video frame dataset: decode every PNG once, keep the clip on the device
(the evaluation part of ``neuroquant_tpu/data/videoset.py``): sorted
directory listing, uint8 -> /255, torchvision-style center crop,
``final_size`` = crop_h * crop_w."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from neuroquant_tpu_torch.utils.device import resolve_device


def _read_image(path: str) -> np.ndarray:
    """uint8 HWC RGB image."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def center_crop(img: np.ndarray, crop_hw: Tuple[int, int]) -> np.ndarray:
    """torchvision center_crop semantics for HWC arrays."""
    ch, cw = crop_hw
    h, w = img.shape[:2]
    if (h, w) == (ch, cw):
        return img
    top = int(round((h - ch) / 2.0))
    left = int(round((w - cw) / 2.0))
    if top < 0 or left < 0:
        pad_h, pad_w = max(ch - h, 0), max(cw - w, 0)
        img = np.pad(img, ((pad_h // 2, pad_h - pad_h // 2),
                           (pad_w // 2, pad_w - pad_w // 2), (0, 0)))
        h, w = img.shape[:2]
        top = int(round((h - ch) / 2.0))
        left = int(round((w - cw) / 2.0))
    return img[top:top + ch, left:left + cw]


class VideoDataSet:
    """All frames of one clip as one NHWC float32 tensor on `device`.

    Attributes:
      frames:     (N, crop_h, crop_w, 3) float32 in [0, 1]
      final_size: crop_h * crop_w
    """

    def __init__(self, cfg: dict, data_path: str, device=None):
        device = resolve_device(device)
        names = sorted(os.listdir(data_path))
        self.paths = [os.path.join(data_path, x) for x in names]
        self.crop_h, self.crop_w = cfg["crop_h"], cfg["crop_w"]
        frames_u8 = np.stack([
            center_crop(_read_image(p), (self.crop_h, self.crop_w))
            for p in self.paths])
        self.final_size = self.crop_h * self.crop_w
        # upload uint8 (4x fewer bytes) and normalize on the device
        u8 = torch.from_numpy(frames_u8).to(device)
        self.frames = u8.to(torch.float32) / 255.0

    def __len__(self) -> int:
        return len(self.paths)
