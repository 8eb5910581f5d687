"""Launch shapes of the three layout kernels (pack_cf, unpack_cf,
unpack_frames), shared
by the CPU emulation tests (test_torch_layout_tiles.py) and the card tests
(test_torch_kernels_cuda.py). Plans come from shapes alone."""

from neuroquant_tpu_torch.ops import tail_fused as tf

BUNNY_BLOCKS = [(5, 53, 176, 2), (5, 44, 148, 2)]
BUNNY_HEAD = (3, 37, 3)
# NeRV Bunny-3M: the tail from 160 x 320 (24 -> 24 * 4, twice), head 24 -> 3
NERV_BLOCKS = [(3, 24, 96, 2), (3, 24, 96, 2)]
NERV_HEAD = (3, 24, 3)
# PNeRV Bunny-3M: the post-fusion tail from 320 x 640 (100 -> 100 * 4), head
# 100 -> 3 at f=2
PNERV_BLOCKS = [(3, 100, 400, 2)]
PNERV_HEAD = (3, 100, 3)


def plan(name):
    """(plan, f) of a named geometry."""
    if name == "bunny":              # HNeRV Bunny-3M tail, 160 x 320, f=4
        return tf.plan_geometry(160, 320, BUNNY_BLOCKS, BUNNY_HEAD)
    if name == "bunny_prefix":       # its fused prefix block, 40 x 80
        return tf._prefix_plan(40, 80, 5, 64, 848), 1
    if name == "nerv_bunny":         # NeRV Bunny-3M tail, 160 x 320, f=4
        return tf.plan_geometry(160, 320, NERV_BLOCKS, NERV_HEAD)
    if name == "nerv_bunny_prefix":  # its fused prefix block 36 -> 384
        return tf._prefix_plan(40, 80, 3, 36, 384), 1
    if name == "pnerv_bunny":        # PNeRV Bunny-3M tail, 320 x 640, f=2
        return tf.plan_geometry(320, 640, PNERV_BLOCKS, PNERV_HEAD)
    if name == "uvg":                # HNeRV UVG-3M tail, 160 x 320, f=6
        return tf.plan_geometry(160, 320, [(5, 53, 396, 3), (5, 44, 148, 2)],
                                BUNNY_HEAD)
    if name == "small":              # the card tests' small fixture, f=4
        return tf.plan_geometry(16, 24, [(5, 5, 16, 2), (3, 4, 12, 2)],
                                (3, 3, 3), tm=128)
    if name == "tiny":               # the conftest tiny HNeRV tail, f=4
        return tf.plan_geometry(20, 40, [(3, 17, 224, 4)], (3, 14, 3))
    if name == "width_tiled":        # the JAX _unpack_kernel5 plan, f=4
        return tf.plan_geometry(4, 480, [(3, 17, 224, 4)], (3, 14, 3))
    # UVG-like edge plans: widths that are no multiple of 4 or of the tile
    f = int(name[1:name.index("_")])
    w = int(name[name.index("w") + 1:])
    blocks = {2: [(5, 8, 16 * 4, 2)], 3: [(5, 8, 12 * 9, 3)],
              4: [(3, 8, 10 * 16, 4)],
              6: [(5, 8, 12 * 9, 3), (3, 12, 8 * 4, 2)]}[f]
    return tf.plan_geometry(5, w, blocks, (3, blocks[-1][2] // (
        blocks[-1][3] ** 2), 3), tm=128)


# pack_cf: (plan, channels c, batch)
PACK_CASES = [
    ("bunny", 53, 1), ("bunny", 53, 2),                 # the tail entry
    ("bunny_prefix", 64, 1), ("bunny_prefix", 64, 2),   # the prefix entry
    ("nerv_bunny", 24, 1), ("nerv_bunny", 24, 2),       # NeRV's entries
    ("nerv_bunny_prefix", 36, 1), ("nerv_bunny_prefix", 36, 2),
    ("pnerv_bunny", 100, 1), ("pnerv_bunny", 100, 2),   # PNeRV's entry
    ("small", 5, 2), ("small", 8, 2), ("small", 13, 2),
    ("tiny", 17, 2),
    *((f"f2_w{w}", c, 2) for w in (13, 131) for c in (1, 3, 5, 13, 53, 64,
                                                       100)),
]

# unpack_frames: (plan, frame channels c, batch)
UNPACK_CASES = [
    ("bunny", 3, 1), ("bunny", 3, 2), ("uvg", 3, 1),
    ("nerv_bunny", 3, 1), ("nerv_bunny", 3, 2),
    ("pnerv_bunny", 3, 1), ("pnerv_bunny", 3, 2),      # sigmoid head, f=2
    ("small", 3, 2), ("tiny", 3, 2), ("width_tiled", 3, 2),
    *((f"f{f}_w{w}", 3, 2) for f in (2, 3, 4, 6) for w in (13, 37, 301)),
    *((f"f{f}_w37", c, 1) for f in (2, 4) for c in (1, 5, 13)),
]


def case_id(case):
    return "-".join(str(v) for v in case)
