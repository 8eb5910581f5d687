#!/usr/bin/env python3
"""Peak device memory and times of one calibration step of the port at
HNeRV Bunny-3M, batch 2, for the port package of a given checkout: runs
``chip_smoke.py``'s calibration-step phase (of the checkout this script
lies in) on ``neuroquant_tpu_torch`` imported from --root. With the parent
commit unpacked by ``git archive`` into a directory, two calls compare two
commits on one card. Needs one NVIDIA GPU and nvcc.

  python3 scripts/torch_step_memory.py [--root DIR]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    import chip_smoke
    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.ops import tail_fused as tf
    from neuroquant_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        print("torch_step_memory: needs one CUDA device", file=sys.stderr)
        return 2
    resolve_device("cuda")
    print(chip_smoke._card_line())
    print(f"package: {os.path.dirname(os.path.dirname(tf.__file__))}")
    cfg = validate_config(get_config(os.path.join(
        HERE, "configs", "HNeRV", "Bunny_1280x640_3M.yaml")), "hnerv")
    cfg["workers"] = 0
    rng = np.random.RandomState(chip_smoke.SEED)
    model = build_model("hnerv", cfg, device="cuda")
    sd = chip_smoke._seeded_state_dict(model, rng)
    del model
    frames_dir = tempfile.mkdtemp(prefix="nq_step_frames_")
    try:
        chip_smoke._write_frames(frames_dir, rng)
        chip_smoke._gradient_phase(torch, tf, cfg, sd, frames_dir)
    finally:
        shutil.rmtree(frames_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
