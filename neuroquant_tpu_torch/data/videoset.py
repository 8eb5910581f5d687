"""Video frame dataset: decode every PNG once, keep the clip on the device
(the counterpart of ``neuroquant_tpu/data/videoset.py``): sorted directory
listing, uint8 -> /255, torchvision-style center crop, per-frame
``norm_idx`` = idx / N, ``final_size`` = crop_h * crop_w, and the
reference's sample dict, with the previous and next frames in diff mode
(``diff_enc``)."""

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
      norm_idx:   (N,) float32, idx / N
      final_size: crop_h * crop_w
    """

    def __init__(self, cfg: dict, data_path: str, device=None):
        device = resolve_device(device)
        names = sorted(os.listdir(data_path))
        self.paths = [os.path.join(data_path, x) for x in names]
        self.crop_h, self.crop_w = cfg["crop_h"], cfg["crop_w"]
        self.diff = bool(cfg.get("diff_enc", False))
        frames_u8 = np.stack([
            center_crop(_read_image(p), (self.crop_h, self.crop_w))
            for p in self.paths])
        self.final_size = self.crop_h * self.crop_w
        # upload uint8 (4x fewer bytes) and normalize on the device
        u8 = torch.from_numpy(frames_u8).to(device)
        self.frames = u8.to(torch.float32) / 255.0
        n = len(self.paths)
        self.norm_idx = torch.arange(n, dtype=torch.float32,
                                     device=device) / n

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        """The reference's sample dict: in diff mode the frame with its
        previous and next ones (the first and last frames stand in for
        their missing neighbours), else the frame, its index and its
        norm_idx."""
        if self.diff:
            id_p = idx - 1 if idx != 0 else idx
            id_f = idx + 1 if idx != len(self) - 1 else idx
            return {"img_id": idx, "img_gt": self.frames[idx],
                    "img_p": self.frames[id_p], "img_f": self.frames[id_f]}
        return {"img": self.frames[idx], "idx": idx,
                "norm_idx": float(idx) / len(self)}

    def batches(self, batch_size: int, indices=None, drop_last: bool = False):
        """Iterator of (frame batch, norm_idx batch, index batch) over
        `indices` (default: every frame in order)."""
        idxs = np.asarray(indices if indices is not None
                          else np.arange(len(self)))
        n = len(idxs)
        stop = n - n % batch_size if drop_last else n
        for s in range(0, stop, batch_size):
            sel = torch.as_tensor(idxs[s:s + batch_size],
                                  device=self.frames.device)
            yield self.frames[sel], self.norm_idx[sel], sel
