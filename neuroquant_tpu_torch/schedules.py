"""Learning-rate schedules parsed from strings like ``cosine_0.1_1_0.1``,
and the seen/unseen frame split (the counterpart of
``neuroquant_tpu/schedules.py``).

The schedule is a function of training progress t in [0, 1), evaluated per
step on the host as a Python float: the training loop writes it into the
optimizer's parameter group before each step.
"""

from __future__ import annotations

import math
import random


def lr_multiplier(lr_type: str, t: float, eta_min: float = 0.05) -> float:
    """Multiplier on the base lr at training progress t in [0, 1).

    ``cosine_<up_ratio>_<up_pow>_<min_lr>``: a warm-up from min_lr to 1 over
    the first up_ratio of training, then a half cosine floored at eta_min.
    ``hybrid_<up_ratio>_<up_pow>_<down_pow>_<min_lr>_<final_lr>``: the same
    warm-up, then a power decay to final_lr."""
    parts = lr_type.split("_")
    kind = parts[0]
    if "hybrid" in kind:
        up_ratio, up_pow, down_pow, min_lr, final_lr = [
            float(x) for x in parts[1:]]
        if t < up_ratio:
            return min_lr + (1.0 - min_lr) * (t / up_ratio) ** up_pow
        return 1 - (1 - final_lr) * ((t - up_ratio)
                                     / (1.0 - up_ratio)) ** down_pow
    if "cosine" in kind:
        up_ratio, up_pow, min_lr = [float(x) for x in parts[1:]]
        if t < up_ratio:
            return min_lr + (1.0 - min_lr) * (t / up_ratio) ** up_pow
        cos = 0.5 * (math.cos(math.pi * (t - up_ratio) / (1 - up_ratio))
                     + 1.0)
        return max(cos, eta_min)
    raise NotImplementedError(f"unknown lr_type {lr_type!r}")


def make_lr_schedule(lr_type: str, base_lr: float, total_steps: int,
                     eta_min: float = 0.05):
    """step -> lr over the flat step counter, t = step / total_steps. The
    step is the count of updates made before the one the lr is for, the
    counter optax's schedules read."""
    def schedule(step: int) -> float:
        return base_lr * lr_multiplier(lr_type, step / total_steps, eta_min)
    return schedule


def data_split(img_list, split_num_list, shuffle_data: bool = False,
               rand_num: int = 0):
    """Split ``a_b_c``: in every window of c frames the first a are training
    ("seen") frames and those at positions >= b are validation ("unseen")."""
    valid_train_length, total_train_length, total_data_length = split_num_list
    img_list = list(img_list)
    if shuffle_data:
        random.Random(rand_num).shuffle(img_list)
    train_list, val_list = [], []
    for cur_i, frame_id in enumerate(img_list):
        if (cur_i % total_data_length) < valid_train_length:
            train_list.append(frame_id)
        elif (cur_i % total_data_length) >= total_train_length:
            val_list.append(frame_id)
    return train_list, val_list
