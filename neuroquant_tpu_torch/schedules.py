"""Seen/unseen frame split (the part of ``neuroquant_tpu/schedules.py`` that
evaluation uses)."""

from __future__ import annotations

import random


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
