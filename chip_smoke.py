#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU, at HNeRV Bunny-3M
(640x1280, configs/HNeRV/Bunny_1280x640_3M.yaml), NeRV Bunny-3M
(configs/NeRV/Bunny_1280x640_3M.yaml) and PNeRV Bunny-3M
(configs/PNeRV/Bunny_1280x640_3M.yaml) with seeded random weights, and the
unit-scope calibration (calibrate_network --scope block|layer) at HNeRV
and NeRV Bunny-3M, and the reduced-precision modes (calibrate_network
--compute_dtype bfloat16, regress --matmul_precision bfloat16) at HNeRV
Bunny-3M.

  python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure exits non-zero):
  1. build  -- compile neuroquant_tpu_torch/csrc/*.cu with nvcc (sm_90a)
  2. kernels -- every kernel of the decode path against its plain PyTorch
     version on the card, at the shapes the decode gives it (the conv's
     emit z, y and the pair zy, with and without GELU on the input; the
     head is the cout-48 tile with ragged K runs of 37); times of the
     kernel, the plain version and one PyTorch library call of the same
     function (CUDA events, fp32, TF32 off); per conv its bound on the fp32
     pipes and on the tensor cores, and the MACs it executes beside the
     useful ones; per layout kernel (pack_cf, unpack_frames) also the
     card's own time of the kernel and of the library call (torch.profiler),
     and pack_cf at the calibration step's batch 2 too
  3. kernels of the calibration step -- at batch 2: each conv's forward as
     the step launches it (zy where a GELU follows, no GELU on the input),
     dx pass (GELU' epilogue; the prefix's splits K, the head's has runs
     of 3) and dW pass (twice: the same bits), act_in held against the
     plain version too, and unpack_cf, the same way (with its device times)
  4. decode -- 4 embeddings through the kernel path and the plain unpacked
     path; they must agree, with 4 tail_conv_cf, 2 pack_cf and 1
     unpack_frames launches per decode; a profiler window over 20 decodes:
     the card's busy time per decode, its idle share, its time by kernel
  5. serving -- a quantized artifact (Hadamard, channel-wise, max scales,
     precision 6 5 4 5 5 6 6) evaluated through
     ``neuroquant_tpu_torch.methods.eval_quantized.main`` on 8 seeded
     1280x720 PNG frames, with --eval_fps
  6. calibration step -- one phase-2 step's loss and gradients, kernel
     path against the plain unpacked path in fp32 and in float64 on the
     same fp32 fake-quantized weights; the codes where a float64
     fake-quant would part from the fp32 one, and the gradients' gap from
     such a reference at their alphas and elsewhere; its launches; its
     forward, backward and optimizer times; a profiler window; then the
     same step with fq_impl='pallas' (the grouped fake-quant kernels)
     against fq_impl='jnp' on the same kernel tail: loss, gradients, one
     fq_ada and one fq_ada_bwd launch, its times and profiler window
  7. calibrate -- ``neuroquant_tpu_torch.methods.calibrate_network.main``
     at Bunny-3M on the 8 frames from a .pth of the seeded weights, batch 2,
     80 steps (1 phase-1 and 19 phase-2 epochs): every step's launches (8
     tail_conv_cf, 4 tail_conv_dw_cf, 2 pack_cf, 2 unpack_cf), finite
     state, both guards, and the artifact read back by eval_quantized
  8. fake-quant kernels -- the grouped forward (fq_uaq, fq_ada: UAQ,
     AdaRound soft and hard, mixed rounding), one launch for the seven
     Bunny-3M weight layers, against the plain chain on the card: 1e-6 of
     the output's largest value and no flipped rounding decision; the
     backward (fq_uaq_bwd, fq_ada_bwd), one launch, against the closed form
     and autograd through the plain chain; the same without the transform
     and with per-layer scales; both passes' times against their bounds;
     the whole ``quantize_params`` call on both fq_impls, forward alone
     and forward plus backward, one launch each way
  9. calibrate, --fq_impl pallas -- phase 7 again on the fake-quant
     kernels: one fq_uaq and one fq_uaq_bwd launch per phase-1 step, one
     fq_ada and one fq_ada_bwd per phase-2 step, beside the 8 / 4 / 2 / 2,
     the four PSNR blocks within 0.02 dB of phase 7's
 10. bitstream -- ``compress.main`` on that artifact, then
     ``eval_quantized.main --from_bitstream``: the stream decodes to the
     artifact's codes, PSNR within 0.01 dB of the artifact's state eval,
     decode launches 4 / 2 / 1; stream bytes, bpp, the native coder's times
 11. stage 2 -- one batch's Hessian-vector product on the kernels
     (``fused_tail: pallas_hvp``, the forward-mode tail) against the plain
     unpacked path (1e-3 of each leaf's largest) and that path in float64
     (1e-4), with its launches; then
     ``neuroquant_tpu_torch.methods.bit_assign.main`` at Bunny-3M, batch 2,
     from a .pth of the seeded weights on the 8 seeded frames, toy
     candidates, once per route (omega on --hvp_impl xla and pallas,
     fisher_diag on the production tail): the same winner, the two HVP
     routes' per-layer omega scores within 1e-4 of each layer's sum of
     |Hv * v|, tail_conv_cf, tail_conv_dw_cf, pack_cf and unpack_cf
     launched and unpack_frames not on pallas; seconds per candidate and
     per batch, launches per batch and peak memory of each route
 12. stage 1 -- at batch 1, the config's: phase 3's kernels again (each
     conv's forward, dx and dW pass and unpack_cf against their plain
     versions, times beside bounds and cuDNN's conv2d_input and
     conv2d_weight), and unpack_frames' forward and backward; one training
     step (encoder, fused tail, loss, backward) against the plain unpacked
     path (loss 1e-5; every leaf's gradient, encoder included, 1e-3 of its
     largest against the plain path in float64, and in fp32 unless cuDNN's
     fp32 is what misses), its launches (8 / 4 / 2 / 2 / 1), its forward /
     backward / optimizer split, a profiler window, its peak memory; then
     ``neuroquant_tpu_torch.methods.regress.main`` on the 8 frames for 3
     epochs (eval every epoch, --profile): every step's launches, finite
     losses, the [profile] lines, s/step, model_latest.pth and epoch3.pth
     reloaded strictly, and --eval_only --weight epoch3.pth reproducing the
     last eval's PSNR to 1e-3 dB
 13. NeRV Bunny-3M at full width and depth, through the phases above: its
     kernels at the decode's shapes (phase 2) and a training step's at
     batch 1 and 2 (phase 3: the prefix 36 -> 384 at 40x80, the tail
     24 -> 96, 96 -> 384 and the head 384 -> 48 at 160x320), the decode
     (phase 4, launches 4 / 2 / 1), one calibration step (phase 6,
     launches 8 / 4 / 2 / 2), a stage-1 step and regress (phase 12), the fake-quant
     kernels at its seven layers (phase 8), calibrate_network on both
     fq_impls (phases 7 and 9), the bitstream (phase 10) and bit_assign
     (phase 11)
 14. PNeRV1 Bunny-3M at full width and depth, its fusion stages in bf16
     as the config says, through the same phases: the post-fusion tail's
     kernels (the block 104 -> 400 at 320x640, the head 400 -> 16 at f=2;
     pack_cf and unpack_cf at c = 100; the sigmoid unpack_frames), the
     decode (launches 2 / 1 / 1; once more with fp32 fusion stages), the
     calibration and stage-1 steps with fp32 fusion stages at fp32's
     tolerances and with the config's bf16 at BF16_TOL (launches 4 / 2 /
     1 / 1, and 2 + 2 fake-quant launches a pallas step: 19 layers in 16 +
     3), regress, the fake-quant kernels at the 19 layers, calibrate_network
     on both fq_impls, the bitstream, bit_assign with two toy allocations
     (with and without --remat, the tail checkpointed layer by layer: both
     peaks); then PNeRV2: decode, one calibration step (one fake-quant
     launch for its 15 layers) and calibrate_network
 15. unit scope -- calibrate_network --scope block (stream bf16 cache,
     fq_impl jnp) and --scope layer (shared fp32 cache, fq_impl pallas,
     fisher_diag, --input_prob 0.5) at HNeRV Bunny-3M, 40 steps a unit,
     each artifact read by eval_quantized, the second through compress and
     eval_quantized --from_bitstream, and NeRV Bunny-3M at --scope block
     (20 steps a unit): every unit's log lines and finite state, the
     launches over these runs (each kernel of the decode and the
     fake-quant's fq_uaq, fq_ada, fq_ada_bwd at least once); then the fp32
     harvest against a float64 harvest (CONV_TOL) and the bf16 stream
     cache within one bf16 unit of it; one step of block 4 (the largest
     unit, 44 -> 37*4 channels, 5x5, 320x640) against the same step in
     float64 (loss LOSS_TOL, alpha gradients GRAD_TOL), mse and
     fisher_diag, and on fq_impl pallas against jnp (the same weights,
     FQ_LOSS_TOL, FQ_GRAD_TOL); each unit's step at batch 2 on both
     fq_impls: ms (20 steps back to back), the port's launches and the
     card's kernels a step, its idle share, one host synchronisation a
     chunk; harvest seconds, cache bytes, each run's peak memory
 16. data parallel at HNeRV Bunny-3M -- 8 network-calibration steps at
     batch 2 (both fq_impls) and 8 stage-1 steps at batch 2 through the
     CLIs' run functions: in one process; (a) through the rank function
     the CLIs spawn (--mesh_devices), world size 1 over NCCL, bitwise
     equal to the one-process run; (b) two ranks sharing cuda:0 over gloo
     (a harness arrangement: one card), one frame a rank, each step's loss
     within LOSS_TOL and every leaf within GRAD_TOL of the one-process
     run, the ranks ending identical, each rank launching the step
     kernels; (c) the same for 8 stage-1 steps of PNeRV1 Bunny-3M (fp32
     fusion stages), its shortcuts' batch norm taking the statistics of
     both ranks' frames; ms a step of each ((b), (c) no speed-up figure)
 17. loss landscape at HNeRV Bunny-3M -- compute_surface on the 11x11
     grid at batch 4 and compute_line on 21 points, one decode on the
     kernels a point (launches 4 / 2 / 1 each); three points of each held
     to the plain unpacked decode (DECODE_TOL), the surface not constant;
     seconds a point
 18. bench -- ``python -m neuroquant_tpu_torch.bench --iters 264`` in its
     own process: its JSON line printed here, its phase-2 it/s and decode
     FPS
 19. bf16 at HNeRV Bunny-3M (run after phase 12) -- the tail kernels'
     bf16 instantiations against their plain versions on the card: the
     decode's convs at batch 1 and a calibration step's forward, dx and
     dW at batch 2 (a bf16 output within one bf16 unit of each element
     beyond CONV_TOL of the largest, the share that differs printed; dW
     and db 1e-5 of the
     largest), pack_cf from fp32 and from bf16, unpack_cf to bf16 and to
     fp32, unpack_frames to fp32 and bf16 frames and on the width-tiled
     plan (bit for bit, one unit; pack_cf and unpack_frames also from
     inputs 1, 3 and 7 elements off 16 bytes; pack_cf and unpack_cf at
     PNeRV's c = 100 entry, unpack_frames at its sigmoid head; the layout
     kernels timed on the card by the event method, hot and cold, beside
     their bound and library call); each timed beside its plain version,
     its bound (bf16 FLOPs at 989 TFLOP/s or bf16 bytes) and cuDNN's or
     PyTorch's bf16 call; ``calibrate_network --compute_dtype bfloat16``
     with phase 9's settings (every step's launches phase 9's on the bf16
     instantiations; the PSNR blocks against phase 9's within
     BF16_PSNR_TOL), ``compress`` and ``eval_quantized --from_bitstream``;
     one bf16 calibration step of HNeRV, NeRV and PNeRV1 Bunny-3M against
     their fp32 step (BF16_TOL), HNeRV's timed in turns with it; ``regress
     --matmul_precision bfloat16`` for phase 12's 3 epochs (every step's
     launches phase 12's on the bf16 instantiations, finite losses,
     --eval_only reproducing the last eval) and a stage-1 step and a
     decode timed in turns with the default precision, with profiler
     windows; both flags through --mesh_devices' rank function at world
     size 1 over NCCL (bitwise to one process); calibrate_network
     --compute_dtype bfloat16 and regress --matmul_precision bfloat16 for
     NeRV, PNeRV1 and PNeRV2 Bunny-3M as phases 7 and 12 run them
 20. dec_norm and activations -- HNeRV Bunny-3M with ``dec_norm: batch,
     dec_acts: swish`` and NeRV Bunny-3M with ``dec_norm: instance,
     dec_acts: relu`` (seeded weights, the 8 seeded frames), on the plain
     unpacked chain: a decode at batch 2 launching none of the port's
     kernels and matching a float64 run on the card, one stage-1 step's
     loss and gradients and one HVP batch on both --hvp_impl routes
     against float64, then calibrate_network, compress and eval_quantized
     --from_bitstream

The second-to-last line is one JSON object per kernel: its launches over
the calibrate_network run (phase 7's for the tail's kernels, phase 9's for
the fake-quant entries), its largest error against the plain version, and
its times and bound summed over one decode's launches (the decode's
kernels), one calibration step's (tail_conv_dw_cf, unpack_cf) or one
``quantize_params`` call's grouped launch over its seven layers (fq_uaq,
fq_ada; the backward's fq_uaq_bwd, fq_ada_bwd); per-launch figures under
"per_launch"; its launches per stage-2 batch and per stage-1 step
("per_stage1_step") beside them, and the stage-1 step's batch-1 launch
shapes under "stage1_per_launch"; NeRV's per-launch records (phase 13)
under "nerv_per_launch", its launches under "nerv_launches"; PNeRV1's
(phase 14) under "pnerv_per_launch" and "pnerv_launches", PNeRV2's
launches under "pnerv2_launches"; the launches over phase 15's runs
under "unit_scope_launches", over phase 16's runs in this process under
"dp_launches" and on each gloo rank under "dp_rank_launches" (PNeRV1's
two ranks under "pnerv_dp_rank_launches"), over phase 17's surface and
line under "landscape_launches". Then one object per bf16 instantiation
(phase 19), named with "_bf16": its launches over phase 19's
calibrate_network and regress runs, its checks, its times and bound
summed as its fp32 row's are. The last line is {"ok": true, "device":
...}.
"""

from __future__ import annotations

import glob
import json
import logging
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOP_PER_S = 495e12   # H100 SXM TF32 tensor cores, dense
PEAK_BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
SEED = 0
N_FRAMES = 8
PRECISION = [6, 5, 4, 5, 5, 6, 6]
CONV_TOL = 1e-4      # relative to the output's max |value|: fp32, other order
DECODE_TOL = 1e-4    # absolute on frames in [0, 1]
CALIB_BATCH = 2
CALIB_ITERS = 80     # batch 2 over 8 frames: 1 phase-1 and 19 phase-2 epochs
# a calibration step's launches: 4 convs forward and 4 dx passes (the fused
# prefix block and the tail's three layers), their 4 dW passes, the two
# entries' pack_cf and its backward; the packed loss needs no unpack
# (tail_conv_cf_wgmma: every fp32 conv launch, on the TMA and wgmma design)
PER_STEP = {"tail_conv_cf": 8, "tail_conv_dw_cf": 4, "pack_cf": 2,
            "unpack_cf": 2, "unpack_frames": 0, "fq_uaq": 0, "fq_ada": 0,
            "fq_uaq_bwd": 0, "fq_ada_bwd": 0, "tail_conv_cf_bf16": 0,
            "tail_conv_dw_cf_bf16": 0, "pack_cf_bf16": 0,
            "unpack_cf_bf16": 0, "unpack_frames_bf16": 0,
            "tail_conv_cf_wgmma": 8}
# with fq_impl='pallas' a step's quantize_params adds one grouped
# fake-quant launch over its seven layers and one backward launch: fq_uaq
# and fq_uaq_bwd in phase 1, fq_ada and fq_ada_bwd in phase 2
FQ_PHASE1 = dict(PER_STEP, fq_uaq=1, fq_uaq_bwd=1)
FQ_PHASE2 = dict(PER_STEP, fq_ada=1, fq_ada_bwd=1)
# the fake-quant kernel against the plain chain, of the output's largest
# value: its butterfly and quantizer repeat the plain chain's fp32
# operations in their order (the soft form's expf against torch's sigmoid)
FQ_TOL = 1e-6
FQ_LOSS_TOL = 1e-6   # a step's loss, fq_impl pallas against jnp, relative
FQ_GRAD_TOL = 1e-5   # its gradients, of each leaf's largest
# the backward kernel's ddelta and dzp against the closed form and autograd,
# of each channel's sum of the magnitudes of the terms summed: fp32 sums
# over up to 1,600 terms in another order, whose two halves cancel
FQ_SUM_TOL = 1e-5
PSNR_TOL = 0.02      # dB between the two calibrate runs' eval blocks
STREAM_PSNR_TOL = 0.01   # dB, the stream's eval against the state's
# one step's gradients, kernel path vs the plain unpacked path (cuDNN): fp32
# sums over ~1e5 positions in other orders through 7 layers; of each
# leaf's largest |gradient|
GRAD_TOL = 1e-3
LOSS_TOL = 1e-5      # relative
# per-layer omega scores, --hvp_impl pallas against xla, of the layer's sum
# of |Hv * v|: each score is a sum of products that cancel, in fp32 over
# ~1e5 positions in other orders
STAGE2_TOL = 1e-4
# one batch's Hv on the kernels against the plain path in float64, of each
# leaf's largest: fp32 through seven layers and two differentiations (the
# plain path in fp32 is held to GRAD_TOL: cuDNN's algorithms for the 5x5
# convs at 160x320 and 320x640 lose more)
HV64_TOL = 1e-4
# a PNeRV leaf whose gradient comes from cuDNN on both routes (the encoder,
# the excitation conv, the fusion stages): where the plain fp32 route
# misses float64 by more than the check's tolerance, the kernel route is
# held to CUDNN64_X times that miss (the same cuDNN fp32 convs, on inputs
# that part in fp32's last bits), that miss to CUDNN64_TOL (cuDNN's fp32
# HVP missed float64 by up to 7.8e-3 of a leaf at HNeRV's shapes), and
# the kernel route to the plain fp32 route within the fp32 tolerance
CUDNN64_X = 2.0
CUDNN64_TOL = 1e-2
# PNeRV1's fusion stages in bf16 (its config's bsm_dtype): the kernel and the
# plain paths run the same bf16 ops on inputs that part in fp32's last bits
# (and cuDNN's bf16 backward parts from run to run), so bf16's rounding
# (2^-8) parts some of a stage's values and cotangents by a unit, and a
# leaf upstream (KFc, BatchNorm, the blocks' convs) sums such cotangents
# over 320x640 positions: gradients and per-layer scores are held to eight
# units there (of the leaf's largest, of the layer's sum|Hv*v|; up to
# 7.5e-3 on an NVIDIA H100 at Bunny-3M, 1.1e-2 on the CPU at a smaller
# config of the same structure), and to GRAD_TOL, FQ_GRAD_TOL, HV64_TOL and
# STAGE2_TOL with the stages in fp32
BF16_TOL = 2.0 ** -5
# phase 19: the tail kernels with a bf16 instantiation
BF16_KERNELS = ("tail_conv_cf", "tail_conv_dw_cf", "pack_cf", "unpack_cf",
                "unpack_frames")
# a bf16 step's gradients against the fp32 step's: BF16_TOL of each leaf's
# largest, and no less than BF16_TOL of BF16_FLOOR times the step's largest
# gradient: a leaf's bf16 error is bf16's unit of the cotangents it sums,
# which scale with the step's, not with a sum that cancels (PNeRV1's first
# gate: ~1e-10, against the head's ~1e-5, at the tiny CPU configuration)
BF16_FLOOR = 1e-3
# phase 19's calibrate_network in bf16 against phase 9's fp32 run: the
# three blocks evaluated before calibrating are fp32 evals of the same
# weights (PSNR_TOL); the calibrated block within BF16_PSNR_TOL dB plus a
# tenth of what fp32 calibration gained over the unoptimized block (bf16
# parts each step's gradients by ~1-3% of a leaf, phase 6's BF16_TOL, so
# the 80 Adam steps end near, not on, the fp32 run's state)
BF16_PSNR_TOL = 0.05
# a stage-1 step's launches (batch 1): the calibration step's, the prefix's
# dx included (the gradient reaches the encoder), and the unpack of the
# frames the loss reads; its backward is the plain VJP, as in JAX
PER_STAGE1_STEP = dict(PER_STEP, unpack_frames=1)
STAGE1_EPOCHS = 3    # regress.main on the 8 frames: 8 steps an epoch
STAGE1_PSNR_TOL = 1e-3   # dB, --eval_only against the last in-training eval
UNIT_ITERS = 40      # calibrate_network --scope block|layer, steps a unit
UNIT_NERV_ITERS = 20
UNIT_TIMED_STEPS = 10    # a unit's step timed back to back, one chunk
REPO = os.path.dirname(os.path.abspath(__file__))
HNERV_CONFIG = os.path.join("configs", "HNeRV", "Bunny_1280x640_3M.yaml")
NERV_CONFIG = os.path.join("configs", "NeRV", "Bunny_1280x640_3M.yaml")
PNERV_CONFIG = os.path.join("configs", "PNeRV", "Bunny_1280x640_3M.yaml")
_CONFIGS = {"hnerv": HNERV_CONFIG, "nerv": NERV_CONFIG,
            "pnerv": PNERV_CONFIG, "pnerv2": PNERV_CONFIG}
# PNeRV's post-fusion tail runs from pack start 0 with no fused prefix: a
# step's launches are its two convs forward and their dx passes, their two
# dW passes, one pack_cf and its backward; a decode's two convs, one pack_cf
# and one unpack_frames
PNERV_PER_STEP = dict(PER_STEP, tail_conv_cf=4, tail_conv_dw_cf=2, pack_cf=1,
                      unpack_cf=1, tail_conv_cf_wgmma=4)
PER_DECODE = {k: 0 for k in PER_STEP}
PER_DECODE.update(tail_conv_cf=4, pack_cf=2, unpack_frames=1,
                  tail_conv_cf_wgmma=4)
PNERV_PER_DECODE = dict(PER_DECODE, tail_conv_cf=2, pack_cf=1,
                        tail_conv_cf_wgmma=2)
FQ_GROUP = 16        # layers one fake-quant launch takes (MAX_LAYERS)
# the port's own kernels, by their CUDA function names, in a profile
PORT_KERNELS = ("tail_conv", "dw_reduce", "pack_cf", "unpack_cf",
                "unpack_frames", "fq_kernel")


def _is_pnerv(arch: str) -> bool:
    return arch.startswith("pnerv")


def _on_cudnn(arch: str, cfg: dict, name: str) -> bool:
    """Whether state-dict leaf `name` of `arch` gets its gradient from cuDNN
    on both routes: PNeRV's leaves outside its post-fusion tail (the last
    block and the head, the only layers on the port's kernels)."""
    if not _is_pnerv(arch):
        return False
    tail = (f"dec_layers.{len(cfg['kfc_strides']) - 1}.", "dec_head_layers.")
    return not name.startswith(tail)


def _hold_to_float64(errs, tol64, tol_plain, cudnn):
    """Leaf by leaf, `errs` {name: (kernel route vs float64, plain fp32
    route vs float64, kernel route vs plain fp32 route)}: the kernel route
    within `tol64` of float64; a leaf on cuDNN on both routes
    (`cudnn(name)`) whose plain route misses float64 by more than `tol64`
    within CUDNN64_X times that miss, the miss within CUDNN64_TOL, and the
    kernel route within `tol_plain` of the plain route."""
    for name, (k64, p64, kp) in errs.items():
        if cudnn(name) and p64 > tol64:
            print(f"    {name} on cuDNN on both routes: {k64:.2e} against "
                  f"float64, the plain route's own {p64:.2e} (held to "
                  f"{CUDNN64_X} x {p64:.2e}, that to {CUDNN64_TOL:.0e}); "
                  f"{kp:.2e} from the plain route (tol {tol_plain:.0e})")
            assert (k64 <= CUDNN64_X * p64 and p64 <= CUDNN64_TOL
                    and kp <= tol_plain), (name, k64, p64, kp)
        else:
            assert k64 <= tol64, (name, k64, p64)


def _per_step(arch: str) -> dict:
    """A calibration step's launches on the tail's kernels."""
    return PNERV_PER_STEP if _is_pnerv(arch) else PER_STEP


def _per_decode(arch: str) -> dict:
    return PNERV_PER_DECODE if _is_pnerv(arch) else PER_DECODE


def _per_stage1_step(arch: str) -> dict:
    return dict(_per_step(arch), unpack_frames=1)


def _bf16(counts: dict) -> dict:
    """Launch counts with the tail kernels' moved to their bf16
    instantiations (what a bf16 step or decode launches)."""
    out = dict(counts)
    for k in BF16_KERNELS:
        out[k + "_bf16"], out[k] = out[k], 0
    out["tail_conv_cf_wgmma"] = 0
    return out


def _n_layers(arch: str, cfg) -> int:
    from neuroquant_tpu_torch.models import quant_layer_paths

    return len(quant_layer_paths(arch, cfg))


def _fq_launches(arch: str, cfg) -> int:
    """Grouped fake-quant launches per quantize_params call: one for every
    FQ_GROUP layers (PNeRV1's 19 take two)."""
    return -(-_n_layers(arch, cfg) // FQ_GROUP)


def _fq_phases(arch: str, cfg):
    """A --fq_impl pallas step's launches, phase 1 and phase 2."""
    n = _fq_launches(arch, cfg)
    return (dict(_per_step(arch), fq_uaq=n, fq_uaq_bwd=n),
            dict(_per_step(arch), fq_ada=n, fq_ada_bwd=n))


def _precision(arch: str, cfg) -> list:
    """The bits of every quantized layer: PRECISION, and for PNeRV's 15 or
    19 layers PRECISION's pattern repeated."""
    if not _is_pnerv(arch):
        return list(PRECISION)
    return [PRECISION[i % len(PRECISION)] for i in range(_n_layers(arch, cfg))]


def _out_bias(cfg) -> str:
    """The head's out_img: the config's, PNeRV's sigmoid (no key)."""
    return str(cfg.get("out_bias", "sigmoid"))


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


_SECTION = {"label": None, "t0": 0.0}


def _section(label=None):
    """Print a section's header, and the seconds since the last header
    (``_section()`` closes the last section)."""
    now = time.time()
    if _SECTION["label"] is not None:
        print(f"  ({_SECTION['label']}: {now - _SECTION['t0']:.1f} s)")
    _SECTION.update(label=label, t0=now)
    if label is not None:
        print(f"[{label}]")


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, n: int = 5, tries: int = 3):
    """Device time of one call of `fn`, summed over the kernels it
    launches (torch.profiler, CUPTI): what the card spends when the host
    does not hold it back. A trace now and then holds no device event: up
    to `tries` windows; None when none has device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neuroquant_tpu_torch.utils.profiling import device_rows

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(r[0] for r in device_rows(prof.key_averages()))
        if us > 0:
            return us / 1e3 / n
    return None


def _layout_record(shape, fn, plain, lib, nbytes):
    """A layout kernel's row: back-to-back ms (CUDA events over 20 calls,
    host time when the host sets the pace) and the card's own time
    (profiler), for the wrapper and for one PyTorch library call of the same
    function; the plain version's ms; the bound by bytes."""
    bound_ms, by = _bound(nbytes, 0)
    return dict(shape=shape, ms=_time_ms(fn), device_ms=_device_ms(fn),
                plain_ms=_time_ms(plain, iters=3, warmup=1),
                library_ms=_time_ms(lib),
                library_device_ms=_device_ms(lib), bound_ms=bound_ms,
                bound_by=by, mbytes=nbytes / 1e6)


def _layout_line(rec) -> str:
    def ms(v):
        return "not measured" if v is None else f"{v:.4f}"
    return (f"{rec['ms']:.4f} ms back to back, {ms(rec['device_ms'])} on the "
            f"device (plain {rec['plain_ms']:.4f}; library "
            f"{rec['library_ms']:.4f}, {ms(rec['library_device_ms'])} on the "
            f"device; bound {rec['bound_ms']:.4f} by {rec['bound_by']})")


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _bound_tc(nbytes: float, flops: float) -> float:
    """The bound of a kernel that multiplies on the tensor cores at fp32
    accuracy: three TF32 products per fp32 product, or the bytes."""
    return max(nbytes / PEAK_BYTES_PER_S,
               3 * flops / PEAK_TF32_FLOP_PER_S) * 1e3


def _conv_extra(tf, p, layer, batch, nbytes, flops):
    """What a conv row reports beside its times: the tensor-core bound, the
    MACs the kernel executes beside the useful ones, its K split."""
    steps = tf._conv_steps(tf._k_blocks(p, layer), layer.cin, layer.taps)[0]
    return dict(bound_tc_ms=_bound_tc(nbytes, flops),
                useful_gmac=flops / 2e9,
                executed_gmac=tf.conv_executed_macs(p, layer, batch) / 1e9,
                k_splits=tf.conv_f32_geometry(layer.cout, p.mp, batch,
                                              len(steps))["splits"])


def _max_err(got, want):
    """(largest |got - want|, CONV_TOL of want's largest value) over one
    tensor or a tuple of them."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    tol = CONV_TOL * max(1.0, *(float(b.abs().max()) for b in want))
    return err, tol


def _seeded_state_dict(model, rng):
    """numpy state dict with the reference key names: U(+-1/sqrt(fan_in))
    weights, small biases, LayerNorm scales near 1, gamma 0.1."""
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("gamma"):
            a = np.full(shape, 0.1)
        elif len(shape) >= 2:
            b = 1.0 / math.sqrt(int(np.prod(shape[1:])))
            a = rng.uniform(-b, b, shape)
        elif k.endswith("weight"):
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = 0.02 * rng.randn(*shape)
        sd[k] = a.astype(np.float32)
    return sd


def _conv_layers(torch, tf, cfg, model):
    """The conv layers of a Bunny-3M model's kernel path: HNeRV's and NeRV's
    four (the fused prefix block, the tail's two blocks, the head), PNeRV's
    two (its post-fusion tail's block and head, from pack start 0): (name,
    plan, layer, kk, bias, real cin, real cout, library conv: (input NCHW
    shape at batch 1, weight OIHW shape, padding)); the real widths of the
    unpacked (f=1) layers, None for the packed ones; the entries' (name,
    plan, real channels)."""
    from neuroquant_tpu_torch.models.layers import collect_tail_params

    convs, entries, pplan = [], [], None
    if hasattr(model, "tail_packed"):            # PNeRV
        t, blocks_m, head_m = (model.n_fused, model.dec_layers,
                               model.dec_head_layers)
        r = blocks_m[t].stride
        th, tw = cfg["crop_h"] // r, cfg["crop_w"] // r  # 320 x 640
    else:
        t, blocks_m, head_m = model.pack_start, model.blocks, model.head_layer
        pre = model.blocks[t - 1]
        strides = [int(s) for s in cfg["dec_strides"]]
        th = cfg["crop_h"] // int(np.prod(strides[t:]))      # 160 x 320
        tw = cfg["crop_w"] // int(np.prod(strides[t:]))
        ph, pw = th // pre.stride, tw // pre.stride            # 40 x 80
        pkern, pbias = pre.conv_params()
        k, pcin, pcout = pkern.shape[0], pkern.shape[2], pkern.shape[3]
        pplan = tf._prefix_plan(ph, pw, k, pcin, pcout)
        with torch.no_grad():
            wrel, brel = tf._relabel(pkern, pbias, pre.stride)
            pl0 = pplan.layers[0]
            pkk = tf._pad_kk(wrel, pl0.cin, pl0.cout).contiguous()
            pbm = torch.nn.functional.pad(brel, (0, pl0.cout - brel.shape[0]))
            pbm = pbm.reshape(pl0.cout, 1)
        convs.append(("prefix", pplan, pl0, pkk, pbm, pcin, pcout,
                      ((1, pcin, ph, pw), (pcout, pcin, k, k), (k - 1) // 2)))
        entries.append(("prefix entry", pplan, pcin))
    blocks, head = collect_tail_params(blocks_m, head_m, t)
    with torch.no_grad():
        plan, kks, bms, f, ch = tf.plan_and_pack(th, tw, blocks, head)
    gh, gw = th, tw
    for j, (w, _, r) in enumerate(blocks):
        kj, cin, cout = w.shape[0], w.shape[2], w.shape[3]
        convs.append((f"tail L{j}", plan, plan.layers[j], kks[j], bms[j],
                      cin if j == 0 else None, cout if j == 0 else None,
                      ((1, cin, gh, gw), (cout, cin, kj, kj),
                       (kj - 1) // 2)))
        gh, gw = gh * r, gw * r
    hk, hcin = head[0].shape[0], head[0].shape[2]
    convs.append(("head", plan, plan.layers[-1], kks[-1], bms[-1], None,
                  None, ((1, hcin, gh, gw), (3, hcin, hk, hk),
                         (hk - 1) // 2)))
    entries.append(("tail entry", plan, blocks[0][0].shape[2]))
    return convs, pplan, plan, f, ch, tuple(entries)


def _cf_input(torch, tf, p, cin, gen, batch=1):
    x = torch.randn((batch, cin, p.mp), generator=gen, device="cuda")
    return (x * tf.border_mask(p, device="cuda")).contiguous()


def _kernel_phase(torch, tf, cfg, model, width_tiled=True):
    """Every kernel at the decode's shapes vs its plain version; returns
    per-kernel records (launches filled in later). `width_tiled`: also the
    width-tiled unpack_frames plan, which is the model's own."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    convs, pplan, plan, f, ch, entries = _conv_layers(torch, tf, cfg, model)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def cf_input(p, cin):
        return _cf_input(torch, tf, p, cin, gen)

    records = {k: {"per_launch": [], "max_abs_err": 0.0}
               for k in ("tail_conv_cf", "pack_cf", "unpack_frames")}
    with torch.no_grad():
        for name, p, layer, kk, bias, cin, cout, lib in convs:
            # the decode's: a GELU follows the tail's blocks
            emit = "y" if name.startswith("tail") else "z"
            x = cf_input(p, layer.cin)
            # the operand the decode packs once per model (HNeRV keeps it)
            w_op = tf.conv_w_operand(kk, p, layer)
            for em, act in (("z", False), ("y", False), ("zy", False),
                            ("z", True), ("y", True)):
                ref = tf.conv_cf_ref(x, kk, bias, p, layer, em, act)
                out = tf.conv_cf(x, kk, bias, p, layer, em, act, w_op)
                torch.cuda.synchronize()
                err, tol = _max_err(out, ref)
                print(f"  tail_conv_cf {name} {layer.cin}->{layer.cout} "
                      f"k{layer.side} emit={em} act_in={act}: max_abs_err "
                      f"{err:.3e} (tol {tol:.1e})")
                assert err <= tol, (name, em, act, err, tol)
                records["tail_conv_cf"]["max_abs_err"] = max(
                    records["tail_conv_cf"]["max_abs_err"], err)
            ms = _time_ms(lambda: tf.conv_cf(x, kk, bias, p, layer, emit,
                                             w_op=w_op))
            plain_ms = _time_ms(lambda: tf.conv_cf_ref(x, kk, bias, p, layer,
                                                       emit), iters=5)
            xs, ws, pad = lib
            xl = torch.randn(xs, generator=gen, device=dev)
            wl = torch.randn(ws, generator=gen, device=dev) * 0.05
            bl = torch.zeros(ws[0], device=dev)
            lib_ms = _time_ms(lambda: F.conv2d(xl, wl, bl, padding=pad))
            flops = tf.conv_cf_flops(p, layer, 1, cin, cout)
            nbytes = 4 * (x.numel() + kk.numel() + layer.cout
                          + layer.cout * p.mp)
            bound_ms, by = _bound(nbytes, flops)
            extra = _conv_extra(tf, p, layer, 1, nbytes, flops)
            records["tail_conv_cf"]["per_launch"].append(dict(
                shape=f"{name} {layer.cin}->{layer.cout} k{layer.side} "
                      f"grid {p.h}x{p.w} emit={emit}",
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by, gflop=flops / 1e9,
                mbytes=nbytes / 1e6, **extra))
            print(f"  tail_conv_cf {name}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                  f"F.conv2d {lib_ms:.4f}, bound {bound_ms:.4f} by {by}, "
                  f"on the tensor cores {extra['bound_tc_ms']:.4f}; "
                  f"{flops / 1e9:.2f} GFLOP -> "
                  f"{flops / ms / 1e9:.2f} TFLOP/s; MACs executed "
                  f"{extra['executed_gmac']:.2f} G for "
                  f"{extra['useful_gmac']:.2f} G useful)")

        # batch 1 for the decode's two entries; batch 2, the calibration
        # step's, outside the decode's sum
        for batch, key in ((1, "per_launch"), (CALIB_BATCH,
                                               "calibration_per_launch")):
            for name, p, c in entries:
                x = torch.randn((batch, p.h, p.w, c), generator=gen,
                                device=dev)
                ref, out = tf.pack_cf_ref(x, p), tf.pack_cf(x, p)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                print(f"  pack_cf {name} {tuple(x.shape)} -> "
                      f"{tuple(out.shape)}: max_abs_err {err:.3e} (tol 0, a "
                      f"copy)")
                assert err == 0.0, (name, err)
                rec = _layout_record(
                    f"{name} {tuple(x.shape)}->{tuple(out.shape)}",
                    lambda: tf.pack_cf(x, p), lambda: tf.pack_cf_ref(x, p),
                    lambda: x.permute(0, 3, 1, 2).contiguous(),
                    4 * (x.numel() + out.numel()))
                records["pack_cf"].setdefault(key, []).append(rec)
                print(f"  pack_cf {rec['shape']}: {_layout_line(rec)} "
                      f"(library: permute+contiguous)")

        z = torch.randn((1, plan.layers[-1].cout, plan.mp), generator=gen,
                        device=dev)
        for ob in ("tanh", "sigmoid", "0.5"):
            ref = tf.unpack_frames_ref(z, plan, f, ch, ob)
            out = tf.unpack_frames(z, plan, f, ch, ob)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            print(f"  unpack_frames out_bias={ob} -> {tuple(out.shape)}: "
                  f"max_abs_err {err:.3e} (tol 1e-6)")
            assert err <= 1e-6, (ob, err)
            records["unpack_frames"]["max_abs_err"] = max(
                records["unpack_frames"]["max_abs_err"], err)
        if width_tiled:
            # a plan whose JAX unpack is the width-tiled _unpack_kernel5
            # (f=4, w=480 -> 240-wide tiles): the one kernel covers it
            wplan, wf = tf.plan_geometry(4, 480, [(3, 17, 224, 4)],
                                         (3, 14, 3))
            zw = torch.randn((2, wplan.layers[-1].cout, wplan.mp),
                             generator=gen, device=dev)
            outw = tf.unpack_frames(zw, wplan, wf, 48, "tanh")
            err = float((outw - tf.unpack_frames_ref(zw, wplan, wf, 48,
                                                     "tanh")).abs().max())
            print(f"  unpack_frames width-tiled plan (f=4, w=480): "
                  f"max_abs_err {err:.3e} (tol 1e-6)")
            assert err <= 1e-6, err
            records["unpack_frames"]["max_abs_err"] = max(
                records["unpack_frames"]["max_abs_err"], err)
            zwl = torch.randn((2, 48, wplan.h, wplan.w), generator=gen,
                              device=dev)
            rec = _layout_record(
                f"{tuple(zw.shape)}->{tuple(outw.shape)} out_bias=tanh",
                lambda: tf.unpack_frames(zw, wplan, wf, 48, "tanh"),
                lambda: tf.unpack_frames_ref(zw, wplan, wf, 48, "tanh"),
                lambda: F.pixel_shuffle(zwl, wf),
                4 * (zwl.numel() + outw.numel()))
            records["unpack_frames"]["width_tiled"] = rec
            print(f"  unpack_frames width-tiled plan {rec['shape']}: "
                  f"{_layout_line(rec)} (library: pixel_shuffle)")
        ob = _out_bias(cfg)
        zl = torch.randn((1, ch, plan.h, plan.w), generator=gen, device=dev)
        rec = _layout_record(
            f"{tuple(z.shape)}->{tuple(out.shape)} out_bias={ob}",
            lambda: tf.unpack_frames(z, plan, f, ch, ob),
            lambda: tf.unpack_frames_ref(z, plan, f, ch, ob),
            lambda: F.pixel_shuffle(zl, f),
            4 * (ch * plan.h * plan.w + out.numel()))
        records["unpack_frames"]["per_launch"].append(rec)
        print(f"  unpack_frames {rec['shape']}: {_layout_line(rec)} "
              f"(library: pixel_shuffle)")
    return records


def _decode_phase(torch, tf, cfg, sd, model, arch="hnerv"):
    """4 decodes of batch 1, kernel path against the plain unpacked path;
    launches per decode; latency; a profiler window. HNeRV and PNeRV decode
    seeded random embeddings, NeRV the encodings of frames 0-3. PNeRV1 with
    bf16 fusion stages also decodes with them in fp32: the gap and the
    time."""
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    dev = torch.device("cuda")
    plain = build_model(arch, dict(cfg, packed_tail="off"), device=dev)
    plain.load_state_dict(state_dict_from_numpy(sd, dev), strict=True)
    if _is_pnerv(arch):
        assert not plain.tail_packed and model.tail_packed
    else:
        assert plain.pack_start is None and model.pack_start == 3
    if arch == "nerv":
        with torch.no_grad():
            embeds = model.encode(torch.arange(4, device=dev) / N_FRAMES)
    else:
        eh, ew = model.cfg.embed_hw                      # 2 x 4
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        c = (cfg["emd_channel"] if _is_pnerv(arch)
             else cfg["enc_channel"][-1])
        embeds = torch.randn((4, eh, ew, c), generator=gen, device=dev)
    with torch.no_grad():
        tf.reset_launch_counts()
        outs = [model.decode(embeds[i:i + 1]) for i in range(4)]
        torch.cuda.synchronize()
        counts = dict(tf.KERNEL_LAUNCHES)
        refs = [plain.decode(embeds[i:i + 1]) for i in range(4)]
        torch.cuda.synchronize()
        err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
        for o in outs:
            assert o.shape == (1, cfg["crop_h"], cfg["crop_w"], 3), o.shape
            assert bool(torch.isfinite(o).all())
        print(f"  4 decodes: kernel path vs plain unpacked path max_abs_err "
              f"{err:.3e} (tol {DECODE_TOL:.0e}); launches {counts}")
        assert err <= DECODE_TOL, err
        assert counts == {k: 4 * v for k, v in _per_decode(arch).items()
                          }, counts
        e1 = embeds[:1]
        k_ms = _time_ms(lambda: model.decode(e1), iters=20)
        p_ms = _time_ms(lambda: plain.decode(e1), iters=20)
        fp32 = None
        if _is_pnerv(arch) and cfg.get("bsm_dtype") == "bfloat16" \
                and getattr(model, "shortcuts", False):
            m32 = build_model(arch, dict(cfg, bsm_dtype="float32"),
                              device=dev)
            m32.load_state_dict(state_dict_from_numpy(sd, dev), strict=True)
            gap = max(float((m32.decode(embeds[i:i + 1]) - o).abs().max())
                      for i, o in enumerate(outs))
            fp32 = dict(decode_ms=_time_ms(lambda: m32.decode(e1), iters=20),
                        max_abs_gap_to_bf16=gap)
            print(f"  bsm_dtype float32 against the config's bfloat16: "
                  f"max|frame difference| {gap:.3e} over the 4 decodes; "
                  f"decode {fp32['decode_ms']:.3f} ms (bfloat16 "
                  f"{k_ms:.3f} ms)")
            del m32
        # the card's busy time per decode and what it spends by kernel; the
        # idle share against the window's wall time (the profiler's own host
        # cost included) and against the decode's time without it
        prof = _profile_steps(torch, lambda: model.decode(e1), n=20,
                              what="decode")
    print(f"  decode latency (batch 1): kernel path {k_ms:.3f} ms, "
          f"plain unpacked path {p_ms:.3f} ms")
    if prof is not None:
        prof["idle_share_of_decode_ms"] = 1 - prof["busy_ms_per_decode"] / k_ms
        print(f"  decode: device busy {prof['busy_ms_per_decode']:.4f} ms per "
              f"decode; idle {100 * prof['idle_share']:.1f}% of the profiled "
              f"window, {100 * prof['idle_share_of_decode_ms']:.1f}% of the "
              f"{k_ms:.3f} ms decode")
    return dict(decode_ms=k_ms, plain_decode_ms=p_ms, max_abs_err=err,
                launches=counts, profile=prof, fp32_fusion=fp32)


def _backward_kernel_phase(torch, tf, cfg, model, batch=CALIB_BATCH):
    """A training step's kernels at Bunny-3M, at `batch` (the calibration
    step's 2, stage 1's 1), against their plain versions: each conv layer's forward as the step runs it (the pair
    'zy' where a GELU follows, else z; no GELU on the input), its dx pass
    (the transposed layer with the GELU' epilogue; the prefix's splits K)
    and its dW pass; both kernels' act_in, which the step no longer uses,
    held against the plain version too; unpack_cf at both entries. Library
    yardsticks: cuDNN's conv2d, conv2d_input and conv2d_weight on the
    unpacked convs; permute().contiguous()."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    B = batch
    convs, _, _, _, _, entries = _conv_layers(torch, tf, cfg, model)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    records = {k: {"per_launch": [], "max_abs_err": 0.0}
               for k in ("tail_conv_cf", "tail_conv_dw_cf", "unpack_cf")}

    def check(kname, what, got, want):
        err, tol = _max_err(got, want)
        print(f"  {kname} {what}: max_abs_err {err:.3e} (tol {tol:.1e})")
        assert err <= tol, (kname, what, err, tol)
        records[kname]["max_abs_err"] = max(records[kname]["max_abs_err"],
                                            err)

    def record(kname, shape, fn, plain, lib, nbytes, flops, extra=None):
        ms = _time_ms(fn, iters=10)
        plain_ms = _time_ms(plain, iters=3, warmup=1)
        lib_ms = _time_ms(lib, iters=10)
        bound_ms, by = _bound(nbytes, flops)
        extra = extra or {}
        if kname == "unpack_cf":       # a layout kernel: the card's own time
            extra = dict(extra, device_ms=_device_ms(fn),
                         library_device_ms=_device_ms(lib))
        records[kname]["per_launch"].append(dict(
            shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=by, gflop=flops / 1e9,
            mbytes=nbytes / 1e6, **extra))
        print(f"  {kname} {shape}: {ms:.4f} ms (plain {plain_ms:.4f}, "
              f"library {lib_ms:.4f}, bound {bound_ms:.4f} by {by}; "
              f"{flops / 1e9:.2f} GFLOP -> {flops / ms / 1e9:.2f} TFLOP/s)"
              + "".join(f"; {k} {v:.4f}" if isinstance(v, float)
                        else f"; {k} {v}" for k, v in extra.items()))

    with torch.no_grad():
        for name, p, layer, kk, bias, cin, cout, lib in convs:
            xs, ws, pad = lib
            act = layer.gelu_in
            x = _cf_input(torch, tf, p, layer.cin, gen, B)
            g = _cf_input(torch, tf, p, layer.cout, gen, B)
            flops = tf.conv_cf_flops(p, layer, B, cin, cout)
            xl = torch.randn((B, *xs[1:]), generator=gen, device=dev)
            wl = torch.randn(ws, generator=gen, device=dev) * 0.05
            gl = torch.randn((B, ws[0], *xs[2:]), generator=gen, device=dev)
            geo = (f"{name} {layer.cin}->{layer.cout} k{layer.side} grid "
                   f"{p.h}x{p.w} batch {B}")

            w_op = tf.conv_w_operand(kk, p, layer)
            # a GELU follows the tail's blocks: they emit the pair
            emit = "zy" if name.startswith("tail") else "z"
            check("tail_conv_cf", f"forward {geo} emit={emit}",
                  tf.conv_cf(x, kk, bias, p, layer, emit, False, w_op),
                  tf.conv_cf_ref(x, kk, bias, p, layer, emit))
            if act:
                check("tail_conv_cf", f"forward {geo} emit=z act_in=True",
                      tf.conv_cf(x, kk, bias, p, layer, "z", True, w_op),
                      tf.conv_cf_ref(x, kk, bias, p, layer, "z", True))
            nbytes = 4 * (x.numel() + kk.numel() + layer.cout
                          + g.numel() * len(emit))
            record("tail_conv_cf", f"forward {geo} emit={emit}",
                   lambda: tf.conv_cf(x, kk, bias, p, layer, emit, False,
                                      w_op),
                   lambda: tf.conv_cf_ref(x, kk, bias, p, layer, emit),
                   lambda: F.conv2d(xl, wl, padding=pad), nbytes, flops,
                   _conv_extra(tf, p, layer, B, nbytes, flops))

            lt = layer.transposed()
            kt = tf._kk_transpose(kk).contiguous()
            om = x if act else None
            wt_op = tf.conv_w_operand(kt, p, lt)
            dx_geo = f"dx {geo} out_mul={act}"
            check("tail_conv_cf", dx_geo,
                  tf.conv_cf(g, kt, None, p, lt, w_op=wt_op, out_mul=om),
                  tf.conv_cf_ref(g, kt, None, p, lt, out_mul=om))
            nbytes = 4 * (g.numel() + kt.numel() + x.numel()
                          * (2 if act else 1))
            record("tail_conv_cf", dx_geo,
                   lambda: tf.conv_cf(g, kt, None, p, lt, w_op=wt_op,
                                      out_mul=om),
                   lambda: tf.conv_cf_ref(g, kt, None, p, lt, out_mul=om),
                   lambda: torch.nn.grad.conv2d_input(xl.shape, wl, gl,
                                                      padding=pad),
                   nbytes, flops, _conv_extra(tf, p, lt, B, nbytes, flops))

            blocks = tf._k_blocks(p, layer)
            dkk, db = tf.conv_cf_dw(x, g, p, layer)
            rkk, rdb = tf.conv_cf_dw_ref(x, g, p, layer, False, blocks)
            check("tail_conv_dw_cf", f"dW {geo}", dkk, rkk)
            check("tail_conv_dw_cf", f"db {geo}", db, rdb)
            again = tf.conv_cf_dw(x, g, p, layer)[0]
            assert torch.equal(again, dkk), "dW differs from run to run"
            if act:
                check("tail_conv_dw_cf", f"dW {geo} act_in=True",
                      tf.conv_cf_dw(x, g, p, layer, True)[0],
                      tf.conv_cf_dw_ref(x, g, p, layer, True, blocks)[0])
            nbytes = 4 * (x.numel() + g.numel() + dkk.numel() + db.numel())
            splits, chunk = tf._dw_split(
                tf.K_STEP * (len(tf._k_steps(blocks, layer.cin,
                                             layer.taps)[0]) + 1),
                layer.cout, B * p.mp)
            record("tail_conv_dw_cf", f"dW {geo}",
                   lambda: tf.conv_cf_dw(x, g, p, layer),
                   lambda: tf.conv_cf_dw_ref(x, g, p, layer, False, blocks),
                   lambda: torch.nn.grad.conv2d_weight(xl, wl.shape, gl,
                                                       padding=pad),
                   nbytes, flops,
                   dict(bound_tc_ms=_bound_tc(nbytes, flops),
                        useful_gmac=flops / 2e9,
                        executed_gmac=tf.conv_executed_macs(p, layer, B)
                        / 1e9, position_splits=splits))

        for name, p, c in entries:
            h, w = p.h, p.w
            g = torch.randn((B, tf._r8(c), p.mp), generator=gen, device=dev)
            out, ref = tf.unpack_cf(g, p, c), tf.unpack_cf_ref(g, p, c)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            shape = f"{name} {tuple(g.shape)}->{tuple(out.shape)}"
            print(f"  unpack_cf {shape}: max_abs_err {err:.3e} (tol 0, a "
                  f"copy)")
            assert err == 0.0, (name, err)
            zl = torch.randn((B, c, h, w), generator=gen, device=dev)
            record("unpack_cf", shape, lambda: tf.unpack_cf(g, p, c),
                   lambda: tf.unpack_cf_ref(g, p, c),
                   lambda: zl.permute(0, 2, 3, 1).contiguous(),
                   4 * 2 * out.numel(), 0)
    return records


def _parted_decisions(torch, params, spec, state):
    """{(layer, alpha leaf): {decision: mask of the codes where the
    AdaRound soft fake-quant in float64 decides otherwise than in fp32}}
    over every spec layer's kernel and bias, the decisions being
    floor(x / delta), the code's clip and h(alpha)'s clip (the plain chain
    of ``quantize_params``)."""
    from neuroquant_tpu_torch.ops import quant as Q
    from neuroquant_tpu_torch.ops.fused_fakequant import _clip_mask
    from neuroquant_tpu_torch.ops.hadamard import fwht, pad_cin_to_pow2
    from neuroquant_tpu_torch.quantization.qmodel import _get

    def dom(w):
        return fwht(pad_cin_to_pow2(w), axis=2) if spec.hadamard else w

    def decisions(x, s, leaf, qmax):
        d, zp, alpha = (s[f"{leaf}_{k}"].to(x.dtype)
                        for k in ("delta", "zp", "alpha"))
        fl = torch.floor(x / d)
        hp = torch.sigmoid(alpha) * (Q.ZETA - Q.GAMMA) + Q.GAMMA
        xz = fl + Q.adaround_soft_targets(alpha) + zp
        return fl, _clip_mask(xz, qmax), _clip_mask(hp, 1.0)

    parted = {}
    for name, pre, bits in zip(spec.layer_names, spec.layer_keys,
                               spec.n_bits):
        w, b = _get(params, pre)
        for leaf, x in (("w", dom(w)), ("b", b)):
            args = (state[name], leaf, 2.0 ** bits - 1)
            d32 = decisions(x, *args)
            d64 = decisions(dom(w.double()) if leaf == "w" else b.double(),
                            *args)
            parted[(name, f"{leaf}_alpha")] = {
                k: a.double() != c for k, a, c in zip(
                    ("floor", "clip", "h_clip"), d32, d64)}
    return parted


def _gradient_phase(torch, tf, cfg, sd, frames_dir, arch="hnerv",
                    grad_tol=GRAD_TOL, fq_grad_tol=FQ_GRAD_TOL, timing=True):
    """One phase-2 calibration step of `arch` at Bunny-3M, batch 2: the
    kernel path (``make_loss``: decode_cf, the packed loss) against the
    plain unpacked path (packed_tail off, the NHWC loss, cuDNN, TF32 off)
    in fp32, and in float64 on the same fp32 fake-quantized weights: the
    loss within LOSS_TOL and every alpha's gradient within GRAD_TOL of its
    leaf's largest, against float64, and against fp32 unless that path is
    what misses float64; the step's launches. Then the reading behind
    that reference: the codes where a float64 fake-quant's decisions
    (floor, the code's clip, h(alpha)'s clip) part from the fp32 one's,
    and the gradients' gap from a float64 reference that quantizes in
    float64, at those codes' alphas and elsewhere. Then the same step with
    fq_impl='pallas': the grouped fake-quant kernels, forward and
    backward, give the 'jnp' step's loss and gradients on the same kernel
    tail, with one fq_ada and one fq_ada_bwd launch more; the step's time
    split into forward, backward and optimizer on both impls, and a
    profiler window of each: the kernel time by name and the device's
    busy share. `grad_tol`: the gradients' tolerance against the plain
    path; `fq_grad_tol` that of fq_impl pallas against jnp (both BF16_TOL
    with bf16 fusion stages); with `timing` False the checks
    alone, without the float64 fake-quant reading, the times and the
    profiles."""
    from torch.func import functional_call

    from neuroquant_tpu_torch.data import VideoDataSet
    from neuroquant_tpu_torch.metrics import lp_loss
    from neuroquant_tpu_torch.models import build_model, tail_plan_for
    from neuroquant_tpu_torch.quantization import (
        adaround_upgrade, init_quant_state, make_spec, quantize_params)
    from neuroquant_tpu_torch.quantization.calibrate import (
        _Decoder, make_loss)
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    dev = torch.device("cuda")
    kern = build_model(arch, cfg, device=dev)
    plain = build_model(arch, dict(cfg, packed_tail="off"), device=dev)
    plain64 = build_model(arch, dict(cfg, packed_tail="off"), device=dev)
    for m in (kern, plain, plain64):
        m.load_state_dict(state_dict_from_numpy(sd, dev), strict=True)
        m.eval()
    plain64.to(torch.float64)
    params = {k: v.detach().clone() for k, v in kern.state_dict().items()}
    bits = _precision(arch, cfg)
    spec = make_spec(arch, cfg, channel_wise=True, scale_method="max",
                     hadamard=True).with_bits(bits)
    spec_fq = make_spec(arch, cfg, channel_wise=True, scale_method="max",
                        hadamard=True, fq_impl="pallas").with_bits(bits)
    state = adaround_upgrade(params, spec, init_quant_state(params, spec))
    data = VideoDataSet(cfg, frames_dir, device=dev)
    frames = data.frames[:CALIB_BATCH]
    with torch.no_grad():
        emb = kern.encode(kern.model_input(data.frames, data.norm_idx)
                          [:CALIB_BATCH])
    plan, f, ch = tail_plan_for(arch, cfg)
    pack = {"gt": tf.pack_targets(frames, plan, f),
            "mask": tf.border_mask(plan, ch=ch, device=dev),
            "denom": cfg["crop_h"] * cfg["crop_w"]}
    keys = [f"{pre}.{leaf}" for pre in spec.layer_keys
            for leaf in ("weight", "bias")]

    def fresh():
        return {ln: {k: v.clone().requires_grad_(k.endswith("alpha"))
                     for k, v in s.items()} for ln, s in state.items()}

    def grads(total, st):
        total.backward()
        torch.cuda.synchronize()
        return float(total.detach()), {(ln, k): st[ln][k].grad
                                       for ln in st for k in st[ln]
                                       if k.endswith("alpha")}

    def step(model, pk, spec=spec):
        st = fresh()
        loss = make_loss(model, params, spec, "adaround", 2.0, pk)
        return grads(loss(st, pk["gt"] if pk else frames, emb, 1)[0], st)

    def step64(fake_quant):
        """The float64 plain decode of the weights `fake_quant(state)`
        makes: its loss and the alphas' gradients."""
        st = fresh()
        qp = fake_quant(st)
        pred = functional_call(_Decoder(plain64, "decode"),
                               {f"model.{k}": qp[k] for k in keys},
                               (emb.double(),))
        return grads(lp_loss(pred, frames.double()), st)

    def worst(a, b):
        """The largest max|a - b| / max|b| over the leaves."""
        return max(float((a[key] - b[key]).abs().max())
                   / max(float(b[key].abs().max()), 1e-30) for key in b)

    tf.reset_launch_counts()
    torch.cuda.synchronize()
    held_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k = step(kern, pack)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    print(f"  peak device memory of one step on the kernel path: "
          f"{peak_mb:.1f} MiB ({held_mb:.1f} MiB held before it)")
    counts = dict(tf.KERNEL_LAUNCHES)
    loss_p, grads_p = step(plain, None)
    loss_64, grads_64 = step64(lambda st: {
        k: v.double() for k, v in quantize_params(
            params, spec, st, mode="adaround", soft=True).items()})
    rel_p, rel_64 = (abs(loss_k - loss_p) / abs(loss_p),
                     abs(loss_k - loss_64) / abs(loss_64))
    kp, k64, p64 = (worst(grads_k, grads_p), worst(grads_k, grads_64),
                    worst(grads_p, grads_64))
    print(f"  one step, kernel path vs plain unpacked path: loss "
          f"{loss_k:.8f} vs {loss_p:.8f} fp32 (rel {rel_p:.2e}) and "
          f"{loss_64:.8f} float64 on the same fake-quantized weights (rel "
          f"{rel_64:.2e}; tol {LOSS_TOL:.0e}); gradients, worst leaf "
          f"max|diff| / max|grad|: vs fp32 {kp:.2e}, vs float64 {k64:.2e}; "
          f"the fp32 plain path's own vs float64 {p64:.2e} (tol "
          f"{grad_tol:.1e}); launches {counts}")
    assert counts == _per_step(arch), counts
    assert rel_p <= LOSS_TOL and rel_64 <= LOSS_TOL, (loss_k, loss_p,
                                                      loss_64)
    assert k64 <= grad_tol, k64
    # against the fp32 plain path too, unless that path is the one off
    assert kp <= grad_tol or p64 > grad_tol, (kp, p64)
    del grads_p

    # the same step with fq_impl='pallas': the same fake-quantized weights
    # bit for bit, so the gradients part only by the cuDNN bf16 stages'
    # own run-to-run rounding where there are such stages
    tf.reset_launch_counts()
    loss_f, grads_f = step(kern, pack, spec_fq)
    counts_f = dict(tf.KERNEL_LAUNCHES)
    rel_f = abs(loss_f - loss_k) / abs(loss_k)
    worst_f = worst(grads_f, grads_k)
    print(f"  the same step, fq_impl pallas vs jnp on the kernel tail: loss "
          f"{loss_f:.7f} vs {loss_k:.7f} (rel {rel_f:.2e}, tol "
          f"{FQ_LOSS_TOL:.0e}); gradients: worst leaf max|diff| / max|grad| "
          f"{worst_f:.2e} (tol {fq_grad_tol:.1e}); launches {counts_f}")
    assert counts_f == _fq_phases(arch, cfg)[1], counts_f
    assert rel_f <= FQ_LOSS_TOL, (loss_f, loss_k)
    assert worst_f <= fq_grad_tol, worst_f
    out = dict(loss=loss_k, plain_loss=loss_p, float64_loss=loss_64,
               loss_rel_err=rel_p, loss_rel_err_float64=rel_64,
               grad_rel_err=kp, grad_rel_err_float64=k64,
               plain_grad_rel_err_float64=p64, grad_tol=grad_tol,
               launches=counts, peak_mib=peak_mb, held_before_mib=held_mb,
               fq_pallas=dict(loss_rel_err=rel_f, grad_rel_err=worst_f,
                              launches=counts_f))
    if not timing:
        return out

    # why the reference quantizes in fp32: the codes whose decisions a
    # float64 fake-quant changes, and the gradient gap at their alphas and
    # elsewhere
    with torch.no_grad():
        by_kind = _parted_decisions(torch, params, spec, state)
    parted = {k: d["floor"] | d["clip"] | d["h_clip"]
              for k, d in by_kind.items()}
    params64 = {k: v.double() for k, v in params.items()}
    loss_q64, grads_q64 = step64(lambda st: quantize_params(
        params64, spec, {ln: {k: v.double() for k, v in s.items()}
                         for ln, s in st.items()},
        mode="adaround", soft=True))
    gap = {k: (grads_k[k].double() - grads_q64[k].double()).abs()
           / max(float(grads_q64[k].abs().max()), 1e-30) for k in parted}
    leaf = max(gap, key=lambda k: float(gap[k].max()))
    at = int(gap[leaf].argmax())
    q64 = dict(
        codes=sum(m.numel() for m in parted.values()),
        parted_codes=sum(int(m.sum()) for m in parted.values()),
        parted_by_decision={d: sum(int(v[d].sum()) for v in by_kind.values())
                            for d in ("floor", "clip", "h_clip")},
        parted_by_leaf={f"{ln}.{k}": int(m.sum())
                        for (ln, k), m in parted.items() if bool(m.any())},
        loss=loss_q64, grad_rel_err=float(gap[leaf].max()),
        grad_rel_err_parted=max((float(g[parted[k]].max())
                                 for k, g in gap.items()
                                 if bool(parted[k].any())), default=0.0),
        grad_rel_err_rest=max(float(g[~parted[k]].max())
                              for k, g in gap.items()),
        worst_at=dict(leaf=".".join(leaf), index=at,
                      kernel_grad=float(grads_k[leaf].flatten()[at]),
                      float64_grad=float(grads_q64[leaf].flatten()[at]),
                      parted=[d for d, m in by_kind[leaf].items()
                              if bool(m.flatten()[at])]))
    print(f"  a float64 fake-quant parts from the fp32 one at "
          f"{q64['parted_codes']} of {q64['codes']} codes (by decision "
          f"{q64['parted_by_decision']}; by leaf {q64['parted_by_leaf']}); "
          f"the kernel path's gradients against a float64 reference that "
          f"quantizes in float64: {q64['grad_rel_err']:.2e} of the leaf's "
          f"largest, {q64['grad_rel_err_parted']:.2e} at those codes' "
          f"alphas, {q64['grad_rel_err_rest']:.2e} at the others; the "
          f"largest gap at {q64['worst_at']}")
    del grads_64, grads_q64, plain64

    def timed(spec):
        """(one step as a callable, its mean forward, backward and optimizer
        ms over 10 steps): forward, backward, Adam over the alphas."""
        st = fresh()
        leaves = [v for s in st.values() for v in s.values()
                  if v.requires_grad]
        opt = torch.optim.Adam(leaves, lr=0.003, eps=1e-8)
        loss = make_loss(kern, params, spec, "adaround", 2.0, pack)

        def one(times=None):
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            total, _ = loss(st, pack["gt"], emb, 1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            total.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if times is not None:
                times.append((t1 - t0, t2 - t1, t3 - t2))

        for _ in range(3):
            one()
        times = []
        for _ in range(10):
            one(times)
        return (one, *(1e3 * sum(t[i] for t in times) / len(times)
                       for i in range(3)))

    # the two impls in turns: jnp, pallas, pallas, jnp
    runs = [timed(sp) for sp in (spec, spec_fq, spec_fq, spec)]
    one, fwd, bwd, upd = runs[0]
    for label, (_, f, b, u) in zip(("jnp", "pallas", "pallas", "jnp"), runs):
        print(f"  step, fq_impl {label} (batch {CALIB_BATCH}, mean of 10): "
              f"forward {f:.3f} ms, backward {b:.3f} ms, optimizer {u:.3f} "
              f"ms, total {f + b + u:.3f} ms")
    prof = _profile_steps(torch, one)
    print("  the same window, fq_impl pallas:")
    prof_f = _profile_steps(torch, runs[1][0])
    return dict(out, float64_fake_quant=q64, forward_ms=fwd,
                backward_ms=bwd, optimizer_ms=upd, profile=prof,
                fq_pallas=dict(
                    out["fq_pallas"],
                    step_ms_jnp=[sum(runs[i][1:]) for i in (0, 3)],
                    step_ms_pallas=[sum(runs[i][1:]) for i in (1, 2)],
                    forward_ms=runs[1][1], backward_ms=runs[1][2],
                    profile=prof_f))


def _profile_steps(torch, one, n=5, what="step", host_rows=0):
    """Device time by kernel name and the device's busy share over n calls
    of `one`, a step or a decode (torch.profiler, CUPTI); 'not measured'
    when the trace has no device time. With `host_rows`, also the host
    operators with the most self CPU time per call (the profiler's own
    cost included)."""
    from torch.profiler import ProfilerActivity, profile

    from neuroquant_tpu_torch.utils.profiling import device_rows

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        torch.cuda.synchronize()      # a decode returns before the card ends
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # kernels and copies; not host ops (their kernels are rows) nor
    # annotated ranges such as the optimizer's step (spans over kernels)
    rows = [(us / 1e3 / n, cnt // n, key)
            for us, cnt, key in device_rows(prof.key_averages())]
    busy = sum(r[0] for r in rows) * n
    if busy <= 0:
        print("  profiler: no device time in the trace (not measured)")
        return None
    rows.sort(reverse=True)
    port = sum(r[0] for r in rows if any(k in r[2] for k in PORT_KERNELS))
    print(f"  profiler over {n} {what}s: device busy {busy:.1f} ms of "
          f"{wall_ms:.1f} ms wall ({100 * busy / wall_ms:.1f}%); the port's "
          f"kernels {100 * port * n / busy:.1f}% of the busy time, cuDNN and "
          f"the rest {100 * (1 - port * n / busy):.1f}%; per {what}:")
    for ms, cnt, key in rows[:14]:
        print(f"    {ms:8.4f} ms  x{cnt:<4d} {key[:90]}")
    host = sorted(((e.self_cpu_time_total / 1e3 / n, e.count // n, e.key)
                   for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), reverse=True)[:host_rows]
    if host:
        print(f"  host self time per {what} (profiled; top {host_rows} of "
              f"{sum(e.count for e in prof.key_averages()) // n} host and "
              f"device records):")
        for ms, cnt, key in host:
            print(f"    {ms:8.4f} ms  x{cnt:<4d} {key[:90]}")
    return {f"wall_ms_per_{what}": wall_ms / n,
            f"busy_ms_per_{what}": busy / n, "busy_share": busy / wall_ms,
            "port_kernel_share_of_busy": port * n / busy,
            "idle_share": 1 - busy / wall_ms,
            "top": [dict(ms=r[0], launches=r[1], name=r[2][:120])
                    for r in rows[:14]],
            "host_top": [dict(ms=r[0], calls=r[1], name=r[2][:120])
                         for r in host]}


def _calibrate_phase(torch, tf, cfg, sd, frames_dir, card, work, fq_impl,
                     arch="hnerv", bf16=False):
    """``calibrate_network.main --fq_impl <fq_impl>`` at Bunny-3M on the 8
    seeded frames, from a .pth of the seeded weights, under the directory
    `work`: both phases, the four eval blocks, both guards, the artifact;
    every step's launches (from a count taken at each loss call); the
    artifact read back by ``eval_quantized``. With `bf16`, ``--compute_dtype
    bfloat16``: every step on the tail kernels' bf16 instantiations, the
    evals in fp32."""
    from neuroquant_tpu_torch.methods import calibrate_network, eval_quantized
    from neuroquant_tpu_torch.quantization import calibrate as tcal

    snaps = []
    make_loss = tcal.make_loss

    def counting(*a, **k):
        fn = make_loss(*a, **k)

        def loss(*args):
            snaps.append(dict(tf.KERNEL_LAUNCHES))
            return fn(*args)
        return loss

    cwd = os.getcwd()
    cap = _Capture()
    try:
        pth = os.path.join(work, f"{arch}_seeded.pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
        tcal.make_loss = counting
        os.chdir(work)             # the run directory goes under results/
        logging.getLogger().addHandler(cap)
        tf.reset_launch_counts()
        t0 = time.time()
        out_path, state, _ = calibrate_network.main([
            "--config", os.path.join(REPO, _CONFIGS[arch]),
            "--arch", arch, "--data_path", frames_dir, "--vid", "Bunny",
            "--outf", f"{arch}_{fq_impl}{'_bf16' if bf16 else ''}",
            "--ckpt", pth, "--precision",
            *map(str, _precision(arch, cfg)), "--hadamard", "--channel_wise",
            "--batch_size", str(CALIB_BATCH), "--iters_w", str(CALIB_ITERS),
            "--lr", "0.003", "--warmup", "0.2", "--fq_impl", fq_impl,
            *(["--compute_dtype", "bfloat16"] if bf16 else [])])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(tf.KERNEL_LAUNCHES)
        # every element of the quantization state is finite
        for ln, s in state.items():
            for k, v in s.items():
                assert bool(torch.isfinite(v).all()), (ln, k)
        logging.getLogger().removeHandler(cap)
        results = eval_quantized.main(["--artifact", out_path,
                                       "--data_path", frames_dir])
    finally:
        tcal.make_loss = make_loss
        logging.getLogger().removeHandler(cap)
        os.chdir(cwd)
    out_path = os.path.join(work, out_path)
    steps = [{k: b[k] - a[k] for k in a} for a, b in zip(snaps, snaps[1:])]
    assert len(snaps) == CALIB_ITERS, len(snaps)
    cast = _bf16 if bf16 else dict
    per_step = cast(_per_step(arch))
    if fq_impl == "pallas":
        # phase 1's steps quantize on fq_uaq, phase 2's on fq_ada
        phase1, phase2 = map(cast, _fq_phases(arch, cfg))
        n1 = sum(d == phase1 for d in steps)
        assert 0 < n1 < len(steps), (n1, steps[:2])
        # the last diff of phase 1 spans the hand-off between the phases
        # (no kernel runs there), so every diff is one step's
        assert all(d == phase1 for d in steps[:n1]), steps[:n1]
        assert all(d == phase2 for d in steps[n1:]), [
            d for d in steps[n1:] if d != phase2][:3]
        per_step = f"phase 1 ({n1} steps) {phase1}, phase 2 {phase2}"
    else:
        assert all(d == per_step for d in steps), [d for d in steps
                                                   if d != per_step][:3]
        per_step = str(per_step)
    text = "\n".join(cap.lines)
    psnrs = [float(v) for v in re.findall(r"best_pred_seen_psnr: ([\d.]+)",
                                          text)]
    assert len(psnrs) == 4, psnrs          # the four eval blocks
    its = float(re.search(r"\[calib\] phase 2 .*\(([0-9.]+) iters/s\)",
                          text)[1])
    psnr = float(results[0])
    assert math.isfinite(psnr) and abs(round(psnr, 2) - psnrs[-1]) <= 0.01, (
        psnr, psnrs)
    for name, n in launches.items():
        # the evals' decodes launch unpack_frames; the fake-quant entries
        # run only under fq_impl pallas; a bf16 run's steps launch the
        # bf16 instantiations (the packed loss needs no unpack) and its
        # fp32 evals the decode's fp32 kernels
        if name.startswith("fq_"):
            want = fq_impl == "pallas"
        elif name.endswith("_bf16"):
            want = bf16 and name != "unpack_frames_bf16"
        else:
            want = not bf16 or name in ("tail_conv_cf", "tail_conv_cf_wgmma",
                                        "pack_cf", "unpack_frames")
        assert (n > 0) == want, (name, launches)
    print(f"  calibrate_network --fq_impl {fq_impl}"
          f"{' --compute_dtype bfloat16' if bf16 else ''}: {CALIB_ITERS} "
          f"steps at "
          f"batch {CALIB_BATCH} in {wall:.1f} s wall (evals included); phase "
          f"2 {its} iters/s; every step's launches {per_step}; run launches "
          f"{launches}")
    print(f"  PSNR fp32 / quant off / quant unopt / quant opt: {psnrs}; "
          f"eval_quantized on the artifact: {psnr:.4f} dB; card {card}")
    return dict(phase2_its=its, wall_s=wall, launches=launches,
                psnr_blocks=psnrs, eval_psnr=psnr, steps=len(snaps),
                artifact=out_path, fq_impl=fq_impl)


def _fq_kernel_phase(torch, tf, cfg, sd, arch="hnerv", full=True):
    """The grouped fake-quant kernels at the seven Bunny-3M weight shapes,
    with the seeded weights and the scales of ``init_quant_state`` (UAQ)
    and ``adaround_upgrade`` (AdaRound soft and hard, and mixed: AdaRound
    on every other layer, nearest rounding on the rest): the forward, one
    launch for the seven layers, bit for bit against the plain chain with
    no flipped rounding decision; the backward, one launch, against the
    closed form (``fake_quant_vjp_ref``) and autograd through the plain
    chain; the same without the transform and with per-layer scales; each
    pass timed against its bound as the calibration's phases call it
    (phase 1: UAQ, ddelta; phase 2: soft AdaRound, dalpha); then the whole
    ``quantize_params`` call on both fq_impls, forward alone and forward
    plus backward, with its launches. `full` False leaves out the runs
    without the transform and with per-layer scales (the same kernel code
    at other shapes) and the whole call's times. Returns per-kernel
    records."""
    from neuroquant_tpu_torch.ops import fused_fakequant as ff
    from neuroquant_tpu_torch.ops.hadamard import next_power_of_two
    from neuroquant_tpu_torch.quantization import (
        adaround_upgrade, init_quant_state, make_spec, quantize_params)
    from neuroquant_tpu_torch.quantization.qmodel import _get
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    params = state_dict_from_numpy(sd, "cuda")
    kw = dict(channel_wise=True, scale_method="max", hadamard=True)
    spec = make_spec(arch, cfg, **kw).with_bits(_precision(arch, cfg))
    spec_fq = make_spec(arch, cfg, fq_impl="pallas", **kw).with_bits(
        _precision(arch, cfg))
    # launches per grouped call: one per FQ_GROUP layers
    nl, nw = _fq_launches(arch, cfg), spec.num_layers
    uaq = init_quant_state(params, spec)
    ada = adaround_upgrade(params, spec, uaq)
    mixed = adaround_upgrade(params, spec, uaq,
                             only=tuple(spec.layer_names[::2]))
    weights = [_get(params, pre)[0] for pre in spec.layer_keys]
    records = {k: {"per_launch": [], "max_abs_err": 0.0}
               for k in ("fq_uaq", "fq_ada", "fq_uaq_bwd", "fq_ada_bwd")}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cots = [torch.randn(w.shape, generator=gen, device="cuda")
            for w in weights]

    def group(state, soft, ws=weights, bits=spec.n_bits, names=None):
        names = names or spec.layer_names
        return [(w, state[n]["w_delta"], state[n]["w_zp"],
                 state[n].get("w_alpha"), b, soft)
                for w, n, b in zip(ws, names, bits)]

    def kname(layers):
        return "fq_ada" if any(l[3] is not None for l in layers) else "fq_uaq"

    def check_forward(label, layers, hadamard):
        """One grouped launch against the plain chain, layer by layer:
        (largest error, elements off by a flipped rounding decision, which
        moves a transformed row by delta / sqrt(C) per element)."""
        tf.reset_launch_counts()
        with torch.no_grad():
            outs = ff.fake_quant_group(layers, hadamard)
        torch.cuda.synchronize()
        launched = {k: v for k, v in tf.KERNEL_LAUNCHES.items() if v}
        assert launched == {kname(layers): nl}, (label, launched)
        top, flips, tol = 0.0, 0, 0.0
        for (w, d, z, a, bits, soft), got in zip(layers, outs):
            want = ff.fake_quant_ref(w, d, z, a, bits, hadamard, soft)
            assert got.shape == want.shape, (got.shape, want.shape)
            err = (got - want).abs()
            c = next_power_of_two(w.shape[2]) if hadamard else 1
            flips += int((err > 0.5 * d / math.sqrt(c)).sum())
            top = max(top, float(err.max()))
            tol = max(tol, FQ_TOL * max(1.0, float(want.abs().max())))
        print(f"  forward, {label}: {nl} {kname(layers)} launch(es) for "
              f"{len(layers)} layers; max_abs_err {top:.3e} (tol {tol:.1e}), "
              f"flipped rounding decisions {flips} (must be 0)")
        assert top <= tol and flips == 0, (label, top, tol, flips)
        records[kname(layers)]["max_abs_err"] = max(
            records[kname(layers)]["max_abs_err"], top)

    def check_backward(label, layers, hadamard):
        """One backward launch (every leaf wanted) against the closed form
        and autograd through the plain chain: dw and dalpha within FQ_TOL
        of the leaf's largest value, the reduced ddelta and dzp within
        FQ_SUM_TOL of each channel's sum of the magnitudes of their
        terms."""
        leaves = [[None if t is None else t.detach().clone().requires_grad_()
                   for t in lay[:4]] for lay in layers]
        flat = [t for lv in leaves for t in lv if t is not None]
        tf.reset_launch_counts()
        outs = ff.fake_quant_group(
            [(*lv, *lay[4:]) for lv, lay in zip(leaves, layers)], hadamard)
        got = torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(outs, cots)), flat,
            allow_unused=True)
        torch.cuda.synchronize()
        launched = {k: v for k, v in tf.KERNEL_LAUNCHES.items() if v}
        name = kname(layers)
        assert launched == {name: nl, name + "_bwd": nl}, (label, launched)
        got = iter(got)
        worst = {"closed form": 0.0, "autograd": 0.0}
        top, unequal = 0.0, 0
        for lv, (w, d, z, a, bits, soft), cot in zip(leaves, layers, cots):
            mine = [None if t is None else next(got) for t in lv]
            closed = ff.fake_quant_vjp_ref(cot, w, d, z, a, bits, hadamard,
                                           soft)
            sums = ff.fake_quant_vjp_ref(
                cot, w, d, z, a, bits, hadamard, soft,
                sum_like=lambda t, like: ff._sum_like(t.abs(), like))[1:3]
            ins = [t.detach().clone().requires_grad_() for t in (w, d, z)]
            if a is not None and soft:
                ins.append(a.detach().clone().requires_grad_())
            plain = list(torch.autograd.grad(
                ff.fake_quant_ref(*ins[:3], a if len(ins) == 3 else ins[3],
                                  bits, hadamard, soft), ins, cot,
                allow_unused=True)) + [None] * (4 - len(ins))
            for ref_name, ref in (("closed form", closed),
                                  ("autograd", plain)):
                for i, (g, r) in enumerate(zip(mine, ref)):
                    if r is None:
                        assert g is None or not bool(g.any()), (label, i)
                        continue
                    err = (g - r).abs()
                    scale = (sums[i - 1].clamp_min(1e-30) if i in (1, 2)
                             else max(1.0, float(r.abs().max())))
                    tol = FQ_SUM_TOL if i in (1, 2) else FQ_TOL
                    rel = float((err / scale).max())
                    assert rel <= tol, (label, ref_name, i, rel)
                    worst[ref_name] = max(worst[ref_name], rel)
                    if ref_name == "closed form":
                        top = max(top, float(err.max()))
                        if i in (0, 3):
                            unequal += int((g != r).sum())
        print(f"  backward, {label}: {nl} {name}_bwd launch(es); against the "
              f"closed form {worst['closed form']:.2e}, autograd "
              f"{worst['autograd']:.2e} (of the largest dw / dalpha, tol "
              f"{FQ_TOL:.0e}; of the channel's term magnitudes for ddelta / "
              f"dzp, tol {FQ_SUM_TOL:.0e}); dw and dalpha elements not equal "
              f"to the closed form's bits: {unequal}")
        records[name + "_bwd"]["max_abs_err"] = max(
            records[name + "_bwd"]["max_abs_err"], top)

    # the model's layers in one group: UAQ, soft, hard, mixed
    for label, state, soft in (("uaq", uaq, True), ("adaround soft", ada,
                                                    True),
                               ("adaround hard", ada, False),
                               ("mixed rounding", mixed, True)):
        layers = group(state, soft)
        check_forward(f"{nw} Bunny-3M layers, {label}", layers, True)
        if label != "adaround hard":
            check_backward(f"{nw} Bunny-3M layers, {label}", layers, True)
    # without the transform (C = C_in), and with per-layer (0-d) scales
    sweeps = ((False, True, "no transform"), (True, False, "per-layer scales"))
    for hadamard, cw, label in sweeps if full else ():
        sp = make_spec(arch, cfg, channel_wise=cw, scale_method="max",
                       hadamard=hadamard).with_bits(_precision(arch, cfg))
        su = init_quant_state(params, sp)
        sa = adaround_upgrade(params, sp, su)
        assert su[sp.layer_names[4]]["w_delta"].dim() == (4 if cw else 0)
        for mode, state, soft in (("uaq", su, True), ("soft", sa, True),
                                  ("hard", sa, False)):
            layers = group(state, soft, bits=sp.n_bits)
            check_forward(f"{nw} layers, {label}, {mode}", layers, hadamard)
            if mode != "hard":
                check_backward(f"{nw} layers, {label}, {mode}", layers,
                               hadamard)

    # the passes timed as the calibration's phases call them: the forward
    # reads each weight and writes its result unpadded (AdaRound: the
    # padded alphas too); phase 1's backward reads the gradient and the
    # weight and writes ddelta, phase 2's reads the alphas too and writes
    # dalpha, padded
    n_w = sum(w.numel() for w in weights)
    n_a = sum(ada[n]["w_alpha"].numel() for n in spec.layer_names)
    n_s = 4 * sum(w.shape[3] for w in weights)
    for name, state, need, nbytes in (
            ("fq_uaq", uaq, None, 4 * (2 * n_w + n_s)),
            ("fq_ada", ada, None, 4 * (2 * n_w + n_s + n_a)),
            ("fq_uaq_bwd", uaq, (False, True, False, False),
             4 * (2 * n_w + n_s)),
            ("fq_ada_bwd", ada, (False, False, False, True),
             4 * (2 * n_w + n_s + 2 * n_a))):
        layers = group(state, True)
        if need is None:
            def run():
                with torch.no_grad():
                    return ff.fake_quant_group(layers, True)

            def plain():
                return [ff.fake_quant_ref(w, d, z, a, b, True, s)
                        for w, d, z, a, b, s in layers]
        else:
            def run():
                return ff._backward(layers, True, cots, [need] * len(layers))

            def plain():
                return [ff.fake_quant_vjp_ref(c, w, d, z, a, b, True, s, need)
                        for (w, d, z, a, b, s), c in zip(layers, cots)]
        tf.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        assert tf.KERNEL_LAUNCHES[name] == nl, dict(tf.KERNEL_LAUNCHES)
        bound_ms, by = _bound(nbytes, 0)
        rec = dict(shape=f"the {nw} {arch} Bunny-3M layers, {nl} launch(es)",
                   ms=_time_ms(run),
                   plain_ms=_time_ms(plain, iters=3, warmup=1),
                   device_ms=_device_ms(run),
                   plain_device_ms=_device_ms(plain), library_ms=None,
                   bound_ms=bound_ms, bound_by=by, mbytes=nbytes / 1e6)
        records[name]["per_launch"].append(rec)
        share = ("not measured" if rec["device_ms"] is None
                 else f"{100 * bound_ms / rec['device_ms']:.0f}% of the bound")
        print(f"  {name}, {nw} layers: {rec['ms']:.4f} ms back to back, "
              f"{rec['device_ms']} ms on the device ({share}); bound "
              f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB) by {by}; plain "
              f"{rec['plain_ms']:.4f} ms, {rec['plain_device_ms']} on the "
              f"device; no single PyTorch call computes the chain")

    # the whole quantize_params call: what a calibration step pays
    keys = [f"{pre}.{leaf}" for pre in spec.layer_keys
            for leaf in ("weight", "bias")]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cot = {k: torch.randn(params[k].shape, generator=gen, device="cuda")
           for k in keys}
    calls = {}
    for mode, state, leaf in (("uaq", uaq, "delta"), ("adaround", ada,
                                                      "alpha")):
        st = {ln: {k: v.clone().requires_grad_(k.endswith(leaf))
                   for k, v in s.items()} for ln, s in state.items()}
        leaves = [v for s in st.values() for v in s.values()
                  if v.requires_grad]

        def forward(sp):
            with torch.no_grad():
                return quantize_params(params, sp, st, mode=mode, soft=True)

        def both(sp):
            out = quantize_params(params, sp, st, mode=mode, soft=True)
            total = sum((out[k] * cot[k]).sum() for k in keys)
            return torch.autograd.grad(total, leaves)

        g_j = both(spec)
        tf.reset_launch_counts()
        g_f = both(spec_fq)
        torch.cuda.synchronize()
        launched = {k: v for k, v in tf.KERNEL_LAUNCHES.items() if v}
        name = "fq_uaq" if mode == "uaq" else "fq_ada"
        assert launched == {name: nl, name + "_bwd": nl}, launched
        worst = max(float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(g_f, g_j))
        assert worst <= FQ_GRAD_TOL, (mode, worst)
        # in turns: jnp, pallas, pallas, jnp
        t = {}
        for label, fn in (("forward", forward), ("forward_backward", both)
                          ) if full else ():
            ms = [_time_ms(lambda: fn(sp), iters=10)
                  for sp in (spec, spec_fq, spec_fq, spec)]
            t[label] = dict(jnp_ms=[ms[0], ms[3]], pallas_ms=[ms[1], ms[2]])
        calls[mode] = dict(t, grad_rel_err=worst, launches=launched)
        times = "; ".join(f"{label} jnp {v['jnp_ms']} ms, pallas "
                          f"{v['pallas_ms']} ms" for label, v in t.items())
        print(f"  quantize_params mode={mode}, {nw} layers: "
              f"{times or 'not timed'}; launches {launched}; gradients "
              f"pallas vs jnp {worst:.2e} (tol {FQ_GRAD_TOL:.0e})")
    records["quantize_params"] = calls
    return records


def _bitstream_phase(torch, tf, calib, frames_dir, card, arch="hnerv"):
    """``compress.main`` on the calibration's artifact, then
    ``eval_quantized.main --from_bitstream`` on the stream."""
    from neuroquant_tpu_torch.coding import codec
    from neuroquant_tpu_torch.methods import compress, eval_quantized

    art = calib["artifact"]
    t0 = time.time()
    so = codec.build_native()
    print(f"  range coder built/loaded in {time.time() - t0:.2f} s: "
          f"{os.path.relpath(so, REPO)}")
    report = compress.main(["--artifact", art, "--data_path", frames_dir])
    stream_path = report["bitstream"]
    assert stream_path == art + ".nqtb" and os.path.exists(stream_path)
    with open(art, "rb") as f:
        artifact = pickle.load(f)
    codes = artifact["int_codes"]
    n_sym = sum(int(np.asarray(c["w"]).size + np.asarray(c["b"]).size)
                for c in codes.values())
    t0 = time.perf_counter()
    stream = codec.compress_artifact(codes)
    t1 = time.perf_counter()
    back = codec.decompress_artifact(stream)
    t2 = time.perf_counter()
    with open(stream_path, "rb") as f:
        assert f.read() == stream
    for name, c in codes.items():
        assert np.array_equal(back[name]["w"], np.asarray(c["w"])), name
        assert np.array_equal(back[name]["b"], np.asarray(c["b"])), name
    assert report["weight_stream_bytes"] == len(stream)
    assert report["pixels"] == (N_FRAMES * artifact["cfg"]["crop_h"]
                                * artifact["cfg"]["crop_w"]), report
    tf.reset_launch_counts()
    results = eval_quantized.main(["--artifact", art, "--data_path",
                                   frames_dir, "--from_bitstream",
                                   stream_path])
    torch.cuda.synchronize()
    launches = dict(tf.KERNEL_LAUNCHES)
    psnr = float(results[0])
    assert math.isfinite(psnr), psnr
    assert abs(psnr - calib["eval_psnr"]) <= STREAM_PSNR_TOL, (
        psnr, calib["eval_psnr"])
    # every decode call is one decode's launches (4 conv, 2 pack_cf and 1
    # unpack_frames; PNeRV 2, 1 and 1); a stream decodes without any
    # fake-quant
    n = launches["unpack_frames"]
    assert n > 0, launches
    assert launches == {k: n * v for k, v in _per_decode(arch).items()
                        }, launches
    print(f"  stream {len(stream)} bytes for {n_sym} symbols, bpp "
          f"{report['bpp']} (embeddings {report['embed_bits']} bits); native "
          f"coder encode {t1 - t0:.3f} s, decode {t2 - t1:.3f} s wall (host)")
    print(f"  eval_quantized --from_bitstream: PSNR {psnr:.4f} dB vs "
          f"{calib['eval_psnr']:.4f} from the artifact's state (tol "
          f"{STREAM_PSNR_TOL}); decode launches {launches}; card {card}")
    return dict(report=report, symbols=n_sym, encode_s=t1 - t0,
                decode_s=t2 - t1, psnr=psnr, launches=launches)


def _stage2_phase(torch, tf, cfg, sd, frames_dir, card, work, arch="hnerv",
                  hv_cfg=None, score_tol=STAGE2_TOL):
    """Stage 2 at Bunny-3M, batch 2: one batch's Hv on the kernels
    (``fused_tail: pallas_hvp``, the forward-mode tail) against the plain
    unpacked path in fp32 and in float64, with its launches; then
    ``neuroquant_tpu_torch.methods.bit_assign.main`` from a .pth of the
    seeded weights on the 8 seeded frames, toy candidates, once per route
    (omega on --hvp_impl xla and pallas, fisher_diag on the production
    tail): the same winner, per-layer omega scores of the two HVP routes
    within `score_tol` of the layer's sum of |Hv * v|, each route's seconds
    per candidate and per batch, its launches per batch, its peak memory.
    `hv_cfg`: the config of the one-batch Hv check, if not `cfg` (PNeRV1's
    with fp32 fusion stages). Against float64 the Hv is held leaf by leaf
    to HV64_TOL, a PNeRV layer on cuDNN on both routes as
    :func:`_hold_to_float64` says."""
    from neuroquant_tpu_torch.data import VideoDataSet
    from neuroquant_tpu_torch.methods import bit_assign
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.quantization import (
        get_perturbation, init_quant_state, make_spec)
    from neuroquant_tpu_torch.quantization import sensitivity as sens
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    dev = torch.device("cuda")
    params = state_dict_from_numpy(sd, dev)
    data = VideoDataSet(cfg, frames_dir, device=dev)
    frames = data.frames
    if _is_pnerv(arch):
        # PNeRV has no default candidates: two toy allocations
        bits = _precision(arch, cfg)
        cands = {"candidate1": bits, "candidate2": [4] * len(bits)}
    else:
        cands = (bit_assign.NERV_CANDIDATES if arch == "nerv"
                 else bit_assign.HNERV_CANDIDATES)
    cand_arg = ";".join(",".join(map(str, c)) for c in cands.values())
    spec = make_spec(arch, cfg, channel_wise=True, scale_method="max"
                     ).with_bits(cands["candidate2"])
    vec = get_perturbation(params, spec, init_quant_state(params, spec))
    batch = sens.draw_batches(N_FRAMES, CALIB_BATCH, 903)[:1]
    hv = {}
    for route, ft, dtype in (("pallas_hvp", "pallas_hvp", torch.float32),
                             ("off", "off", torch.float32),
                             ("off fp64", "off", torch.float64)):
        model = build_model(arch, dict(hv_cfg or cfg, fused_tail=ft),
                            device=dev)
        model.load_state_dict(params, strict=True)
        model.to(dtype)
        torch.cuda.synchronize()
        tf.reset_launch_counts()
        t0 = time.time()
        hv[route] = sens.hessian_vector_product(
            model, spec, [v.to(dtype) for v in vec], frames.to(dtype),
            data.norm_idx, batch)
        torch.cuda.synchronize()
        if route == "pallas_hvp":
            one_batch_s, per_batch = time.time() - t0, dict(tf.KERNEL_LAUNCHES)
        del model

    def leaf_errs(got, want):
        return [float((a.double() - b.double()).abs().max())
                / max(float(b.abs().max()), 1e-30) for a, b in zip(got, want)]

    leaf_err = leaf_errs(hv["pallas_hvp"], hv["off"])
    leaf_err64 = leaf_errs(hv["pallas_hvp"], hv["off fp64"])
    plain_err64 = leaf_errs(hv["off"], hv["off fp64"])
    hv_err = max(leaf_err)
    print(f"  Hv of one batch, kernels (pallas_hvp) vs plain unpacked path: "
          f"leaf max|diff| / max|Hv| "
          f"{' '.join(f'{e:.2e}' for e in leaf_err)} (tol {GRAD_TOL:.0e}); "
          f"vs the plain path in float64 "
          f"{' '.join(f'{e:.2e}' for e in leaf_err64)} (tol "
          f"{HV64_TOL:.0e}); the plain path's own against float64 "
          f"{' '.join(f'{e:.2e}' for e in plain_err64)}; "
          f"{one_batch_s:.3f} s; launches {per_batch}")
    assert hv_err <= GRAD_TOL, hv_err
    _hold_to_float64(
        {f"{pre}.weight": e for pre, e in zip(
            spec.layer_keys, zip(leaf_err64, plain_err64, leaf_err))},
        HV64_TOL, GRAD_TOL, lambda n: _on_cudnn(arch, cfg, n))
    for k in ("tail_conv_cf", "tail_conv_dw_cf", "pack_cf", "unpack_cf"):
        assert per_batch[k] > 0, per_batch
    assert per_batch["unpack_frames"] == 0, per_batch
    del hv, vec, params, frames

    pth = os.path.join(work, f"{arch}_seeded.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    sc, hvp, fisher = (bit_assign.sensitivity_criterion,
                       sens.hessian_vector_product, sens.fisher_gradient)
    rec = {}

    def counted(fn, key):
        """`fn` (one candidate's batches) timed and its launches counted,
        both per batch; the sum of |Hv * v| per layer kept."""
        def wrapper(model, spec, *args, **kw):
            batches = args[-1] if key == "fisher" else args[-2]
            snap = dict(tf.KERNEL_LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(model, spec, *args, **kw)
            torch.cuda.synchronize()
            n = len(batches)
            launches = {k: (v - snap[k]) / n
                        for k, v in tf.KERNEL_LAUNCHES.items()}
            mags = ([float((h * v).abs().sum()) for h, v in zip(out, args[0])]
                    if key == "hvp" else None)
            rec["calls"].append(dict(seconds=(time.time() - t0) / n,
                                     batches=n, launches=launches,
                                     mags=mags))
            return out
        return wrapper

    def scored(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        total, per_layer = sc(*args, **kw)
        torch.cuda.synchronize()
        rec["candidates"].append(dict(seconds=time.time() - t0,
                                      total=total, per_layer=per_layer))
        return total, per_layer

    routes = (("omega xla", ["--mode", "omega", "--hvp_impl", "xla"]),
              ("omega pallas", ["--mode", "omega", "--hvp_impl", "pallas"]),
              ("fisher_diag", ["--mode", "fisher_diag", "--hvp_impl",
                               "pallas"]))
    if _is_pnerv(arch):
        # the JAX package needed --remat for PNeRV's batch-2 HVP: the peak
        # both ways
        routes += (("omega pallas remat", ["--mode", "omega", "--hvp_impl",
                                           "pallas", "--remat"]),)
    runs = {}
    cwd = os.getcwd()
    try:
        bit_assign.sensitivity_criterion = scored
        sens.hessian_vector_product = counted(hvp, "hvp")
        sens.fisher_gradient = counted(fisher, "fisher")
        os.chdir(work)
        for i, (route, extra) in enumerate(routes):
            rec = {"candidates": [], "calls": []}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tf.reset_launch_counts()
            t0 = time.time()
            best = bit_assign.main([
                "--config", os.path.join(REPO, _CONFIGS[arch]),
                "--arch", arch, "--data_path", frames_dir, "--vid",
                "Bunny", "--outf", f"stage2_{arch}_{i}", "--ckpt", pth,
                "--batch_size", str(CALIB_BATCH), "--channel_wise",
                "--init", "max", "--candidates", cand_arg, *extra])
            torch.cuda.synchronize()
            runs[route] = dict(best=list(best[:2]), score=best[2],
                               wall_s=time.time() - t0,
                               peak_mib=torch.cuda.max_memory_allocated()
                               / 2**20, launches=dict(tf.KERNEL_LAUNCHES),
                               **rec)
    finally:
        bit_assign.sensitivity_criterion = sc
        sens.hessian_vector_product, sens.fisher_gradient = hvp, fisher
        os.chdir(cwd)
    for route, r in runs.items():
        cand = [c["seconds"] for c in r["candidates"]]
        per = [c["seconds"] for c in r["calls"]]
        launches = r["calls"][0]["launches"]
        assert all(c["launches"] == launches for c in r["calls"]), route
        assert len(r["calls"]) == len(cand) == 2, route
        assert all(math.isfinite(c["total"]) for c in r["candidates"])
        print(f"  bit_assign {route}: best {r['best'][0]} {r['best'][1]} "
              f"(score {r['score']:.4e}); {len(cand)} candidates, "
              f"{'/'.join(f'{x:.3f}' for x in cand)} s each; "
              f"{r['calls'][0]['batches']} batches each, "
              f"{'/'.join(f'{x:.4f}' for x in per)} s a batch; launches per "
              f"batch {launches}; peak {r['peak_mib']:.1f} MiB; "
              f"{r['wall_s']:.1f} s wall (FP eval included); card {card}")
        r["launches_per_batch"] = launches
    assert len({tuple(r["best"][1]) for r in runs.values()}) == 1, runs
    xla, pal = runs["omega xla"], runs["omega pallas"]
    worst = 0.0
    for a, b, call in zip(pal["candidates"], xla["candidates"], xla["calls"]):
        for sa, sb, mag in zip(a["per_layer"], b["per_layer"], call["mags"]):
            worst = max(worst, abs(sa - sb) / max(mag, 1e-30))
    print(f"  per-layer omega scores, pallas vs xla: worst |diff| / sum|Hv*v| "
          f"{worst:.2e} (tol {score_tol:.1e})")
    assert worst <= score_tol, worst
    if "omega pallas remat" in runs:
        rem = runs["omega pallas remat"]
        same = max(abs(sa - sb) / max(mag, 1e-30)
                   for a, b, call in zip(rem["candidates"], pal["candidates"],
                                         pal["calls"])
                   for sa, sb, mag in zip(a["per_layer"], b["per_layer"],
                                          call["mags"]))
        # the tail checkpointed layer by layer (fault C5)
        print(f"  --remat (the tail layer by layer, its tangent GELU in "
              f"pieces): peak "
              f"{rem['peak_mib']:.1f} MiB against {pal['peak_mib']:.1f} "
              f"without ({100 * (1 - rem['peak_mib'] / pal['peak_mib']):.1f}% "
              f"below), "
              f"{rem['calls'][0]['seconds']:.4f} s a batch against "
              f"{pal['calls'][0]['seconds']:.4f}; per-layer scores "
              f"{same:.2e} of sum|Hv*v| apart (tol {score_tol:.1e})")
        assert same <= score_tol, same
    pb = pal["launches_per_batch"]
    for k in ("tail_conv_cf", "tail_conv_dw_cf", "pack_cf", "unpack_cf"):
        assert pb[k] > 0, pb
    assert pb["unpack_frames"] == 0, pb
    assert not any(xla["launches_per_batch"].values()), xla
    return dict(hv_one_batch_rel_err=leaf_err, hv_fp64_rel_err=leaf_err64,
                score_tol=score_tol,
                plain_fp64_rel_err=plain_err64, one_batch_s=one_batch_s,
                launches_one_batch=per_batch, omega_rel_err=worst,
                runs=runs)


def _unpack_frames_backward(torch, tf, cfg, model):
    """unpack_frames at a stage-1 step's batch 1, its forward (the kernel)
    and its backward (the VJP of the plain version, as the JAX package's):
    the backward against autograd of the plain forward, and the times of
    both passes beside their bounds by bytes and one PyTorch call of the
    same permutation (pixel_shuffle, pixel_unshuffle)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    _, _, plan, f, ch, _ = _conv_layers(torch, tf, cfg, model)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    ob = _out_bias(cfg)
    z = torch.randn((1, plan.layers[-1].cout, plan.mp), generator=gen,
                    device=dev).requires_grad_()
    out = tf.unpack_frames(z, plan, f, ch, ob)
    g = torch.randn(out.shape, generator=gen, device=dev)
    (dz,) = torch.autograd.grad(out, z, g)
    zr = z.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(tf.unpack_frames_ref(zr, plan, f, ch, ob),
                                  zr, g)
    torch.cuda.synchronize()
    err = float((dz - want).abs().max())
    print(f"  unpack_frames backward {tuple(g.shape)}->{tuple(dz.shape)}: "
          f"max_abs_err {err:.3e} (tol 0: the same plain VJP)")
    assert err == 0.0, err
    zl = torch.randn((1, ch, plan.h, plan.w), generator=gen, device=dev)
    gl = g.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        fwd = _layout_record(
            f"forward {tuple(z.shape)}->{tuple(out.shape)}",
            lambda: tf.unpack_frames(z.detach(), plan, f, ch, ob),
            lambda: tf.unpack_frames_ref(z.detach(), plan, f, ch, ob),
            lambda: F.pixel_shuffle(zl, f),
            4 * (ch * plan.h * plan.w + out.numel()))
    zz = z.detach().requires_grad_()

    def backward():
        o = tf.unpack_frames(zz, plan, f, ch, ob)
        torch.autograd.grad(o, zz, g)

    def plain_backward():
        o = tf.unpack_frames_ref(zz, plan, f, ch, ob)
        torch.autograd.grad(o, zz, g)

    # the backward pass alone: forward+backward less the forward
    both = _layout_record(
        f"forward+backward {tuple(z.shape)}",
        backward, plain_backward, lambda: F.pixel_unshuffle(gl, f),
        4 * (2 * out.numel() + 2 * z.numel()))
    bwd = dict(both, shape=f"backward (plain VJP) {tuple(g.shape)}->"
                           f"{tuple(dz.shape)}",
               ms=both["ms"] - fwd["ms"],
               device_ms=(None if both["device_ms"] is None
                          or fwd["device_ms"] is None
                          else both["device_ms"] - fwd["device_ms"]),
               plain_ms=both["plain_ms"] - fwd["plain_ms"])
    bwd["bound_ms"], bwd["bound_by"] = _bound(
        4 * (out.numel() + 2 * z.numel()), 0)
    for rec, lib in ((fwd, "pixel_shuffle"), (bwd, "pixel_unshuffle")):
        print(f"  unpack_frames {rec['shape']}: {_layout_line(rec)} "
              f"(library: {lib})")
    return dict(forward=fwd, backward=bwd, backward_max_abs_err=err)


def _stage1_step_phase(torch, tf, cfg, sd, frames_dir, arch="hnerv",
                       grad_tol=GRAD_TOL, timing=True):
    """One stage-1 step at Bunny-3M, batch 1: HNeRV's forward (encoder,
    fused prefix and tail on the kernels, unpack_frames), the config's loss
    and the backward, against the plain unpacked path (``fused_tail:
    off``, cuDNN) in fp32 and in float64: the loss within LOSS_TOL and
    every leaf's gradient, encoder included, within GRAD_TOL of its
    largest against float64 (a PNeRV leaf on cuDNN on both routes as
    :func:`_hold_to_float64` says), and against the fp32 plain path
    unless that path is what misses float64; the
    step's launches; its forward / backward / optimizer split over 10
    steps with Adam; a profiler window; its peak memory. `grad_tol` and
    `timing` as in :func:`_gradient_phase`."""
    from neuroquant_tpu_torch.data import VideoDataSet
    from neuroquant_tpu_torch.metrics import loss_fn
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    dev = torch.device("cuda")
    data = VideoDataSet(cfg, frames_dir, device=dev)
    img = data.frames[:1].clone()

    def model_for(ft, dtype=torch.float32):
        m = build_model(arch, dict(cfg, fused_tail=ft), device=dev)
        m.load_state_dict(state_dict_from_numpy(sd, dev), strict=True)
        return m.to(dtype)

    kern = model_for("auto")
    inp = kern.model_input(data.frames, data.norm_idx)[:1].clone()

    def step(model, dtype=torch.float32):
        model.zero_grad(set_to_none=True)
        x = img.to(dtype)
        loss = loss_fn(model(inp.to(dtype)), x, cfg["loss"])
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad for n, p in
                                      model.named_parameters()}

    tf.reset_launch_counts()
    loss_k, g_k = step(kern)
    counts = dict(tf.KERNEL_LAUNCHES)
    plain = model_for("off")
    loss_p, g_p = step(plain)
    del plain
    plain64 = model_for("off", torch.float64)
    loss_64, g_64 = step(plain64, torch.float64)
    del plain64

    def leaf_errs(a, b):
        return {n: float((a[n].double() - b[n].double()).abs().max())
                / max(float(b[n].abs().max()), 1e-30) for n in b}

    def worst(errs):
        name = max(errs, key=errs.get)
        return errs[name], name

    e_kp, e_k64, e_p64 = (leaf_errs(g_k, g_p), leaf_errs(g_k, g_64),
                          leaf_errs(g_p, g_64))
    (kp, kp_leaf), (k64, k64_leaf), (p64, p64_leaf) = (
        worst(e_kp), worst(e_k64), worst(e_p64))
    enc = max((e for n, e in e_k64.items()
               if n.startswith(("encoder.", "enc_layers."))), default=0.0)
    rel_p = abs(loss_k - loss_p) / abs(loss_p)
    rel_64 = abs(loss_k - loss_64) / abs(loss_64)
    print(f"  one stage-1 step (batch 1), kernel path vs plain unpacked path: "
          f"loss {loss_k:.8f} vs {loss_p:.8f} fp32 (rel {rel_p:.2e}) and "
          f"{loss_64:.8f} float64 (rel {rel_64:.2e}; tol {LOSS_TOL:.0e}); "
          f"gradients, worst leaf max|diff| / max|grad|: vs fp32 {kp:.2e} "
          f"({kp_leaf}), vs float64 {k64:.2e} ({k64_leaf}; encoder "
          f"{enc:.2e}); the fp32 plain path's own vs float64 {p64:.2e} "
          f"({p64_leaf}) (tol {grad_tol:.1e}); launches {counts}")
    assert counts == _per_stage1_step(arch), counts
    assert min(rel_p, rel_64) <= LOSS_TOL, (loss_k, loss_p, loss_64)
    _hold_to_float64({n: (e_k64[n], e_p64[n], e_kp[n]) for n in e_k64},
                     grad_tol, grad_tol, lambda n: _on_cudnn(arch, cfg, n))
    # against the fp32 plain path too, unless that path is the one off
    assert kp <= grad_tol or p64 > grad_tol, (kp, p64)
    del g_p, g_64
    out = dict(loss=loss_k, plain_loss=loss_p, float64_loss=loss_64,
               loss_rel_err=rel_p, loss_rel_err_float64=rel_64,
               grad_rel_err=kp, grad_rel_err_float64=k64,
               encoder_grad_rel_err_float64=enc,
               plain_grad_rel_err_float64=p64, grad_tol=grad_tol,
               launches=counts)
    if not timing:
        return out

    opt = torch.optim.Adam(kern.parameters(), lr=cfg["learning_rate"],
                           eps=1e-8)

    def one(times=None):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(kern(inp), img, cfg["loss"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if times is not None:
            times.append((t1 - t0, t2 - t1, t3 - t2))

    for _ in range(3):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_mb = torch.cuda.memory_allocated() / 2**20
    times = []
    for _ in range(10):
        one(times)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    fwd, bwd, upd = (1e3 * sum(t[i] for t in times) / len(times)
                     for i in range(3))
    print(f"  stage-1 step (batch {img.shape[0]}, mean of 10, synchronised "
          f"between the parts): forward {fwd:.3f} ms, backward {bwd:.3f} ms, "
          f"optimizer "
          f"{upd:.3f} ms, total {fwd + bwd + upd:.3f} ms; peak device "
          f"memory {peak_mb:.1f} MiB ({held_mb:.1f} MiB held: weights, "
          f"Adam's moments, the frame)")

    def loop_step():
        """A step as regress's loop runs it: no synchronize."""
        opt.zero_grad(set_to_none=True)
        loss_fn(kern(inp), img, cfg["loss"]).backward()
        opt.step()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        loop_step()
    torch.cuda.synchronize()
    steady_ms = 1e3 * (time.perf_counter() - t0) / 20
    print(f"  stage-1 step, 20 back to back as the training loop runs them "
          f"(one synchronize at the end): {steady_ms:.3f} ms a step")
    prof = _profile_steps(torch, loop_step, host_rows=10)
    return dict(out, forward_ms=fwd, backward_ms=bwd, optimizer_ms=upd,
                step_ms=steady_ms, peak_mib=peak_mb, held_mib=held_mb,
                profile=prof)


def _stage1_run_phase(torch, tf, frames_dir, card, work, arch="hnerv",
                      bf16=False):
    """``regress.main`` at Bunny-3M on the 8 seeded frames, from a copy of
    the config with only epoch (STAGE1_EPOCHS) and eval_freq (1) changed,
    with --profile: every training step's launches (counted at each loss
    call, within each epoch), finite losses, the [profile] lines, s/step
    from the Time/epoch lines; model_latest.pth and epoch3.pth loaded
    strictly into a fresh model with the trained tensors; then --eval_only
    --weight epoch3.pth, whose PSNR must equal the last in-training
    eval's. With `bf16`, all of it under ``--matmul_precision
    bfloat16``."""
    import yaml

    from neuroquant_tpu_torch.config import get_config
    from neuroquant_tpu_torch.methods import common, regress
    from neuroquant_tpu_torch.models import build_model

    base = get_config(os.path.join(REPO, _CONFIGS[arch]))
    cfg_path = os.path.join(work, f"{arch}_stage1.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(dict(base, epoch=STAGE1_EPOCHS, eval_freq=1), f)
    epochs, evals = [], []
    orig_loss, orig_make, orig_eval = (regress.loss_fn,
                                       regress.make_train_epoch,
                                       common.evaluate)

    def counting_loss(*a, **k):
        epochs[-1]["snaps"].append(dict(tf.KERNEL_LAUNCHES))
        return orig_loss(*a, **k)

    def counting_make(*a, **k):
        run = orig_make(*a, **k)

        def run_epoch(*ra, **rk):
            epochs.append({"snaps": [dict(tf.KERNEL_LAUNCHES)]})
            losses, psnrs = run(*ra, **rk)
            torch.cuda.synchronize()
            epochs[-1]["snaps"].append(dict(tf.KERNEL_LAUNCHES))
            epochs[-1]["losses"] = losses.cpu().numpy()
            return losses, psnrs
        return run_epoch

    def recording_eval(*a, **k):
        out = orig_eval(*a, **k)
        evals.append([float(np.mean(v)) for v in out[0]])
        return out

    argv = ["--config", cfg_path, "--arch", arch, "--data_path",
            frames_dir, "--vid", "Bunny",
            *(["--matmul_precision", "bfloat16"] if bf16 else [])]
    tag = f"{arch}_bf16" if bf16 else arch
    cwd = os.getcwd()
    cap = _Capture()
    try:
        regress.loss_fn = counting_loss
        regress.make_train_epoch = counting_make
        common.evaluate = recording_eval
        os.chdir(work)
        logging.getLogger().addHandler(cap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tf.reset_launch_counts()
        t0 = time.time()
        model = regress.main(argv + ["--outf", f"stage1_{tag}",
                                     "--profile"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(tf.KERNEL_LAUNCHES)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        run_dir = os.path.dirname(glob.glob(os.path.join(
            work, "results", f"stage1_{tag}", "*", "Encoder_*",
            "epoch*.pth"))[0])
        trained = {k: v.detach() for k, v in model.state_dict().items()}
        del model
        for name in ("model_latest.pth", f"epoch{STAGE1_EPOCHS}.pth"):
            fresh = build_model(arch, base, device="cuda", seed=1)
            sd = torch.load(os.path.join(run_dir, name), map_location="cuda",
                            weights_only=True)
            fresh.load_state_dict(sd, strict=True)
            for k, v in fresh.state_dict().items():
                assert torch.equal(v, trained[k]), (name, k)
            print(f"  {name}: {len(sd)} tensors, loaded strictly, equal to "
                  f"the trained model's")
        n_train_evals = len(evals)
        regress.main(argv + ["--outf", f"stage1_eval_{tag}", "--eval_only",
                             "--weight", os.path.join(
                                 run_dir, f"epoch{STAGE1_EPOCHS}.pth")])
        torch.cuda.synchronize()
    finally:
        regress.loss_fn, regress.make_train_epoch = orig_loss, orig_make
        common.evaluate = orig_eval
        logging.getLogger().removeHandler(cap)
        os.chdir(cwd)
    assert len(epochs) == STAGE1_EPOCHS, len(epochs)
    per_step = (_bf16 if bf16 else dict)(_per_stage1_step(arch))
    steps = None
    for e in epochs:
        sn = e["snaps"]
        diffs = [{k: b[k] - a[k] for k in a} for a, b in zip(sn, sn[1:])]
        # [forward of step 0, steps 0..n-2 through the forward of the next,
        # backward of the last]
        ends = {k: diffs[0][k] + diffs[-1][k] for k in diffs[0]}
        assert all(d == per_step for d in diffs[1:-1]), [
            d for d in diffs[1:-1] if d != per_step][:3]
        assert ends == per_step, ends
        assert np.isfinite(e["losses"]).all(), e["losses"]
        steps = len(diffs) - 1
    text = "\n".join(cap.lines)
    prof_lines = [m for m in cap.lines if m.startswith("[profile]")]
    assert prof_lines, "no [profile] lines"
    epoch_s = [float(v) for v in re.findall(r"Time/epoch: \tCurrent:([\d.]+)",
                                            text)]
    assert len(epoch_s) == STAGE1_EPOCHS, epoch_s
    assert len(evals) == n_train_evals + 1 == STAGE1_EPOCHS + 1, evals
    last, again = evals[n_train_evals - 1][0], evals[-1][0]
    print(f"  regress.main --arch {arch}"
          f"{' --matmul_precision bfloat16' if bf16 else ''}: "
          f"{STAGE1_EPOCHS} epochs x {steps} "
          f"steps at batch {base['batch_size']} "
          f"in {wall:.1f} s wall (evals included); every step's launches "
          f"{per_step}; losses "
          f"{' '.join(f'{x:.5f}' for e in epochs for x in e['losses'])}; "
          f"s/step by epoch (Time/epoch / {steps}; epoch 2 profiled) "
          f"{' / '.join(f'{t / steps:.4f}' for t in epoch_s)}; run "
          f"launches {launches}; peak {peak_mb:.1f} MiB; card {card}")
    print("  " + "\n  ".join(prof_lines))
    print(f"  eval PSNR by epoch {[round(e[0], 4) for e in evals[:-1]]}; "
          f"--eval_only --weight epoch{STAGE1_EPOCHS}.pth: {again:.6f} dB vs "
          f"{last:.6f} (tol {STAGE1_PSNR_TOL} dB)")
    assert math.isfinite(again) and abs(again - last) <= STAGE1_PSNR_TOL, (
        again, last)
    return dict(epochs=STAGE1_EPOCHS, steps_per_epoch=steps, wall_s=wall,
                launches=launches, per_step=per_step,
                s_per_step=[t / steps for t in epoch_s],
                losses=[float(x) for e in epochs for x in e["losses"]],
                eval_psnr=[e[0] for e in evals[:-1]], eval_only_psnr=again,
                profile_lines=prof_lines, peak_mib=peak_mb)


def _nerv_phase(torch, tf, card, frames_dir, work):
    """Phase 13: NeRV Bunny-3M (configs/NeRV/Bunny_1280x640_3M.yaml, full
    width and depth, seeded weights, the 8 seeded frames): its kernel
    shapes, decode, calibration step, stage 1, calibration on both
    fq_impls, bitstream and stage 2, through the phases above."""
    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    t0 = time.time()
    cfg = validate_config(get_config(os.path.join(REPO, NERV_CONFIG)),
                          "nerv")
    cfg["workers"] = 0
    # what setup_run sets for the 8 frames: the encoding's exact table
    cfg["n_frames"] = N_FRAMES
    model = build_model("nerv", cfg, device="cuda")
    sd = _seeded_state_dict(model, np.random.RandomState(SEED + 13))
    model.load_state_dict(state_dict_from_numpy(sd, "cuda"), strict=True)
    model.eval()
    assert model.pack_start == 3, model.pack_start
    out = {}
    _section("nerv: kernels at the decode's shapes")
    out["kernels"] = _kernel_phase(torch, tf, cfg, model, width_tiled=False)
    for b in (1, CALIB_BATCH):
        _section(f"nerv: kernels of a training step, batch {b}")
        out[f"kernels_b{b}"] = _backward_kernel_phase(torch, tf, cfg, model,
                                                      batch=b)
    _section("nerv: decode")
    out["decode"] = _decode_phase(torch, tf, cfg, sd, model, arch="nerv")
    del model
    _section("nerv: calibration step")
    out["step"] = _gradient_phase(torch, tf, cfg, sd, frames_dir,
                                  arch="nerv", timing=False)
    _section("nerv: stage-1 step")
    out["stage1_step"] = _stage1_step_phase(torch, tf, cfg, sd, frames_dir,
                                            arch="nerv")
    _section("nerv: stage 1, regress")
    out["stage1"] = _stage1_run_phase(torch, tf, frames_dir, card, work,
                                      arch="nerv")
    _section("nerv: fake-quant kernels")
    out["fq"] = _fq_kernel_phase(torch, tf, cfg, sd, arch="nerv",
                                 full=False)
    for fq_impl in ("jnp", "pallas"):
        _section(f"nerv: calibrate, --fq_impl {fq_impl}")
        out[f"calibrate_{fq_impl}"] = _calibrate_phase(
            torch, tf, cfg, sd, frames_dir, card, work, fq_impl,
            arch="nerv")
    worst = max(abs(a - b) for a, b in zip(
        out["calibrate_pallas"]["psnr_blocks"],
        out["calibrate_jnp"]["psnr_blocks"]))
    print(f"  PSNR blocks, fq_impl pallas vs jnp: max diff {worst:.3f} dB "
          f"(tol {PSNR_TOL})")
    assert worst <= PSNR_TOL, worst
    _section("nerv: bitstream")
    out["bitstream"] = _bitstream_phase(torch, tf, out["calibrate_pallas"],
                                        frames_dir, card)
    assert out["bitstream"]["report"]["embed_bits"] == 0
    _section("nerv: stage 2, bit_assign")
    out["stage2"] = _stage2_phase(torch, tf, cfg, sd, frames_dir, card, work,
                                  arch="nerv")
    _section()
    out["seconds"] = time.time() - t0
    print(f"  phase 13 (NeRV) took {out['seconds']:.1f} s; card {card}")
    return out


def _pnerv_phase(torch, tf, card, frames_dir, work):
    """Phase 14: PNeRV1 Bunny-3M (configs/PNeRV/Bunny_1280x640_3M.yaml, full
    width and depth, bf16 fusion stages as the config says, seeded weights,
    the 8 seeded frames): its tail's kernel shapes, decode (and one decode
    with fp32 fusion stages), calibration step, stage 1, the fake-quant
    kernels at its 19 layers (two launches), calibration on both fq_impls,
    bitstream and stage 2 (with and without --remat); then PNeRV2 at the
    same width: decode, a calibration step and calibrate_network."""
    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    t0 = time.time()
    cfg = validate_config(get_config(os.path.join(REPO, PNERV_CONFIG)),
                          "pnerv")
    cfg["workers"] = 0
    assert cfg["bsm_dtype"] == "bfloat16", cfg["bsm_dtype"]
    model = build_model("pnerv", cfg, device="cuda")
    sd = _seeded_state_dict(model, np.random.RandomState(SEED + 14))
    model.load_state_dict(state_dict_from_numpy(sd, "cuda"), strict=True)
    model.eval()
    assert model.tail_packed and model.cfg.bsm_dtype == "bfloat16"
    assert _n_layers("pnerv", cfg) == 19 and _fq_launches("pnerv", cfg) == 2
    out = {}
    _section("pnerv: kernels at the decode's shapes")
    out["kernels"] = _kernel_phase(torch, tf, cfg, model, width_tiled=False)
    for b in (1, CALIB_BATCH):
        _section(f"pnerv: kernels of a training step, batch {b}")
        out[f"kernels_b{b}"] = _backward_kernel_phase(torch, tf, cfg, model,
                                                      batch=b)
    _section("pnerv: decode")
    out["decode"] = _decode_phase(torch, tf, cfg, sd, model, arch="pnerv")
    del model
    # the checks at fp32's tolerances with the fusion stages in fp32, then
    # the config's bf16 stages at BF16_TOL, timed
    cfg32 = dict(cfg, bsm_dtype="float32")
    _section("pnerv: calibration step, fp32 fusion stages")
    out["step_fp32_fusion"] = _gradient_phase(
        torch, tf, cfg32, sd, frames_dir, arch="pnerv", timing=False)
    _section("pnerv: calibration step")
    out["step"] = _gradient_phase(torch, tf, cfg, sd, frames_dir,
                                  arch="pnerv", grad_tol=BF16_TOL,
                                  fq_grad_tol=BF16_TOL)
    _section("pnerv: stage-1 step, fp32 fusion stages")
    out["stage1_step_fp32_fusion"] = _stage1_step_phase(
        torch, tf, cfg32, sd, frames_dir, arch="pnerv", timing=False)
    _section("pnerv: stage-1 step")
    out["stage1_step"] = _stage1_step_phase(torch, tf, cfg, sd, frames_dir,
                                            arch="pnerv", grad_tol=BF16_TOL)
    _section("pnerv: stage 1, regress")
    out["stage1"] = _stage1_run_phase(torch, tf, frames_dir, card, work,
                                      arch="pnerv")
    _section("pnerv: fake-quant kernels, 19 layers in 16 + 3")
    out["fq"] = _fq_kernel_phase(torch, tf, cfg, sd, arch="pnerv",
                                 full=False)
    for fq_impl in ("jnp", "pallas"):
        _section(f"pnerv: calibrate, --fq_impl {fq_impl}")
        out[f"calibrate_{fq_impl}"] = _calibrate_phase(
            torch, tf, cfg, sd, frames_dir, card, work, fq_impl,
            arch="pnerv")
    worst = max(abs(a - b) for a, b in zip(
        out["calibrate_pallas"]["psnr_blocks"],
        out["calibrate_jnp"]["psnr_blocks"]))
    print(f"  PSNR blocks, fq_impl pallas vs jnp: max diff {worst:.3f} dB "
          f"(tol {PSNR_TOL})")
    assert worst <= PSNR_TOL, worst
    _section("pnerv: bitstream")
    out["bitstream"] = _bitstream_phase(torch, tf, out["calibrate_pallas"],
                                        frames_dir, card, arch="pnerv")
    assert out["bitstream"]["report"]["embed_bits"] > 0
    _section("pnerv: stage 2, bit_assign")
    out["stage2"] = _stage2_phase(torch, tf, cfg, sd, frames_dir, card, work,
                                  arch="pnerv", hv_cfg=cfg32,
                                  score_tol=BF16_TOL)

    # PNeRV2: no KFc shortcuts, 15 layers (one fake-quant launch)
    model2 = build_model("pnerv2", cfg, device="cuda")
    sd2 = _seeded_state_dict(model2, np.random.RandomState(SEED + 15))
    model2.load_state_dict(state_dict_from_numpy(sd2, "cuda"), strict=True)
    model2.eval()
    assert _n_layers("pnerv2", cfg) == 15 and _fq_launches("pnerv2", cfg) == 1
    _section("pnerv2: decode")
    out["pnerv2_decode"] = _decode_phase(torch, tf, cfg, sd2, model2,
                                         arch="pnerv2")
    del model2
    _section("pnerv2: calibration step")
    out["pnerv2_step"] = _gradient_phase(torch, tf, cfg, sd2, frames_dir,
                                         arch="pnerv2", timing=False)
    _section("pnerv2: calibrate, --fq_impl pallas")
    out["pnerv2_calibrate"] = _calibrate_phase(
        torch, tf, cfg, sd2, frames_dir, card, work, "pallas", arch="pnerv2")
    _section()
    out["seconds"] = time.time() - t0
    print(f"  phase 14 (PNeRV) took {out['seconds']:.1f} s; card {card}")
    return out


def _unit_run(torch, cfg, sd, frames_dir, card, work, arch, tag, iters,
              extra):
    """``calibrate_network.main --scope ...`` at Bunny-3M on the 8 seeded
    frames, precision 6 5 4 5 5 6 6, Hadamard, channel-wise, batch 2,
    `iters` steps a unit, from a .pth of the seeded weights: every unit's
    log lines and finite state, the four eval blocks, the artifact read
    back by ``eval_quantized`` to the last block's PSNR; its wall time,
    peak memory, each unit's harvest seconds and cache bytes."""
    from neuroquant_tpu_torch.methods import calibrate_network, eval_quantized

    cwd = os.getcwd()
    cap = _Capture()
    pth = os.path.join(work, f"{arch}_seeded.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    try:
        os.chdir(work)             # the run directory goes under results/
        logging.getLogger().addHandler(cap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out_path, state, spec = calibrate_network.main([
            "--config", os.path.join(REPO, _CONFIGS[arch]),
            "--arch", arch, "--data_path", frames_dir, "--vid", "Bunny",
            "--outf", f"{arch}_{tag}", "--ckpt", pth, "--precision",
            *map(str, _precision(arch, cfg)), "--hadamard", "--channel_wise",
            "--batch_size", str(CALIB_BATCH), "--iters_w", str(iters),
            "--lr", "0.003", "--warmup", "0.2", *extra])
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        for ln, s in state.items():
            assert "w_alpha" in s, ln
            for k, v in s.items():
                assert bool(torch.isfinite(v).all()), (ln, k)
        logging.getLogger().removeHandler(cap)
        results = eval_quantized.main(["--artifact", out_path,
                                       "--data_path", frames_dir])
    finally:
        logging.getLogger().removeHandler(cap)
        os.chdir(cwd)
    out_path = os.path.join(work, out_path)
    scope = extra[extra.index("--scope") + 1]
    assert f"{scope}-wise_calib" in out_path, out_path
    text = "\n".join(cap.lines)
    for u, name in enumerate(spec.layer_names):
        assert f"Reconstruction for {scope} {u} ({name})" in text, u
        assert f"[unit {u} {name}] iter {iters}/{iters} loss " in text, u
    losses = [float(v) for v in re.findall(
        rf"\] iter {iters}/{iters} loss ([-\d.e]+)", text)]
    assert len(losses) == len(spec.layer_names) and all(
        math.isfinite(v) for v in losses), losses
    harvest = [float(v) for v in re.findall(r"Cached init time: ([\d.e-]+)",
                                            text)]
    grad_s = [float(v) for v in re.findall(r"Cached grad time: ([\d.e-]+)",
                                           text)]
    cache = [int(v) for v in re.findall(r"\] cache (\d+) bytes", text)]
    assert len(cache) == len(spec.layer_names), cache
    psnrs = [float(v) for v in re.findall(r"best_pred_seen_psnr: ([\d.]+)",
                                          text)]
    assert len(psnrs) == 4, psnrs          # the four eval blocks
    psnr = float(results[0])
    assert math.isfinite(psnr) and abs(round(psnr, 2) - psnrs[-1]) <= 0.01, (
        psnr, psnrs)
    print(f"  calibrate_network {' '.join(extra)} (--arch {arch}, "
          f"--iters_w {iters} a unit): {wall:.1f} s wall (evals included), "
          f"peak {peak:.1f} MiB; harvest s {harvest}; fisher-cache s "
          f"{grad_s}; cache bytes a unit {cache}; last losses {losses}")
    print(f"  PSNR fp32 / quant off / quant unopt / quant opt: {psnrs}; "
          f"eval_quantized on the artifact: {psnr:.4f} dB; card {card}")
    return dict(artifact=out_path, eval_psnr=psnr, psnr_blocks=psnrs,
                wall_s=wall, peak_mib=peak, harvest_s=harvest,
                fisher_cache_s=grad_s, cache_bytes=cache,
                unit_losses=losses, args=extra)


def _unit_step(prob, idx, count, compute_dtype=None):
    """One step's (loss, alpha gradients) of `prob` from its starting
    alphas."""
    import torch

    tr = prob.trainable()
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    total, _, _ = prob.loss(tr, idx, count, **kw)
    total.backward()
    torch.cuda.synchronize()
    return float(total.detach()), {k: v.grad for k, v in tr.items()}, tr


def _unit_records(torch, tf, prob, n=UNIT_TIMED_STEPS):
    """A unit's step at batch 2: ms (CUDA events, n steps back to back
    after 3), the port's launches a step, and over a profiled chunk of n
    steps and its one loss fetch: the card's busy share, device kernels a
    step and the host synchronisations."""
    from torch.profiler import ProfilerActivity, profile

    from neuroquant_tpu_torch.quantization.calib_unit import run_steps
    from neuroquant_tpu_torch.utils.profiling import device_rows

    tr = prob.trainable()
    opt = torch.optim.Adam(list(tr.values()), lr=0.003, eps=1e-8)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    idxs = torch.randint(0, prob.x_fp.shape[0], (n, CALIB_BATCH),
                         generator=gen, device="cuda")

    def draw(count, shape):
        return torch.rand(shape, generator=gen, device="cuda")

    count, _ = run_steps(prob, tr, opt, idxs[:3], 0, draw)
    torch.cuda.synchronize()
    tf.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    count, _ = run_steps(prob, tr, opt, idxs, count, draw)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    launches = {k: v / n for k, v in tf.KERNEL_LAUNCHES.items() if v}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        count, last = run_steps(prob, tr, opt, idxs, count, draw)
        loss = float(last)          # the chunk's one host synchronisation
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    rows = device_rows(events)
    busy = sum(r[0] for r in rows) / 1e3
    syncs = sum(e.count for e in events if e.key == "cudaStreamSynchronize")
    top = [dict(ms=us / 1e3 / n, launches=cnt / n, name=key[:100])
           for us, cnt, key in sorted(rows, reverse=True)[:5]]
    return dict(ms=ms, launches_per_step=launches, top=top,
                device_kernels_per_step=sum(r[1] for r in rows) / n,
                busy_ms_per_step=busy / n if busy > 0 else None,
                idle_share=(1 - busy / wall_ms) if busy > 0 else None,
                host_syncs_per_chunk=syncs, chunk_steps=n, last_loss=loss)


def _unit_scope_phase(torch, tf, cfg, sd, frames_dir, card, work):
    """Phase 15: unit-scope calibration at HNeRV Bunny-3M, full width and
    depth (and NeRV Bunny-3M at block scope), on the 8 seeded frames.
    The main path, its launches counted: calibrate_network --scope block
    (stream cache, fq_impl jnp) and --scope layer (shared cache, fq_impl
    pallas, fisher_diag, QDrop 0.5), each artifact read by eval_quantized,
    the second through compress and eval_quantized --from_bitstream; NeRV
    --scope block. Then the gates: the fp32 harvest against a float64
    harvest, the bf16 stream cache within one bf16 unit of it; one step of
    block 4 (the largest unit) against the same step in float64, mse and
    fisher_diag; that step on fq_impl pallas against jnp. Then the
    records: each unit's step time on both fq_impls, launches, idle share
    and host synchronisations per chunk."""
    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.data import VideoDataSet
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.quantization import (
        init_quant_state, make_spec)
    from neuroquant_tpu_torch.quantization.calib_unit import (
        UnitProblem, harvest_unit_io)
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    t_start = time.time()
    out = {}
    ncfg = validate_config(get_config(os.path.join(REPO, NERV_CONFIG)),
                           "nerv")
    ncfg["workers"] = 0
    nmodel = build_model("nerv", ncfg, device="cuda")
    nsd = _seeded_state_dict(nmodel, np.random.RandomState(SEED + 13))
    del nmodel
    _section("unit scope: calibrate_network, the main path")
    tf.reset_launch_counts()
    out["block_stream_jnp"] = _unit_run(
        torch, cfg, sd, frames_dir, card, work, "hnerv", "unit_block",
        UNIT_ITERS, ["--scope", "block", "--unit_cache", "stream",
                     "--fq_impl", "jnp"])
    out["layer_shared_pallas"] = _unit_run(
        torch, cfg, sd, frames_dir, card, work, "hnerv", "unit_layer",
        UNIT_ITERS, ["--scope", "layer", "--unit_cache", "shared",
                     "--fq_impl", "pallas", "--opt_mode", "fisher_diag",
                     "--input_prob", "0.5"])
    before = dict(tf.KERNEL_LAUNCHES)   # _bitstream_phase resets the count
    out["bitstream"] = _bitstream_phase(torch, tf, out["layer_shared_pallas"],
                                        frames_dir, card)
    out["nerv_block"] = _unit_run(
        torch, ncfg, nsd, frames_dir, card, work, "nerv", "unit_block",
        UNIT_NERV_ITERS, ["--scope", "block"])
    torch.cuda.synchronize()
    out["launches"] = {k: v + before[k]
                       for k, v in tf.KERNEL_LAUNCHES.items()}
    print(f"  launches over the main path (both HNeRV runs, their evals, "
          f"the bitstream, the NeRV run): {out['launches']}")
    for k in ("tail_conv_cf", "pack_cf", "unpack_frames", "fq_uaq", "fq_ada",
              "fq_ada_bwd"):
        assert out["launches"][k] > 0, (k, out["launches"])

    _section("unit scope: harvest against float64")
    dev = torch.device("cuda")
    model = build_model("hnerv", cfg, device=dev)
    params = state_dict_from_numpy(sd, dev)
    model.load_state_dict(params, strict=True)
    model.eval()
    data = VideoDataSet(cfg, frames_dir, device=dev)
    with torch.no_grad():
        emb = model.encode(data.frames)
    spec = make_spec("hnerv", cfg, channel_wise=True, scale_method="max",
                     hadamard=True).with_bits(PRECISION)
    spec_fq = make_spec("hnerv", cfg, channel_wise=True, scale_method="max",
                        hadamard=True, fq_impl="pallas").with_bits(PRECISION)
    state = init_quant_state(params, spec)
    torch.cuda.synchronize()
    t0 = time.time()
    io = harvest_unit_io(model, params, "hnerv", spec, emb)
    torch.cuda.synchronize()
    shared_s = time.time() - t0
    model64 = build_model("hnerv", cfg, device=dev)
    model64.load_state_dict(params, strict=True)
    model64.to(torch.float64)
    io64 = harvest_unit_io(model64, {k: v.double() for k, v in
                                     params.items()}, "hnerv", spec,
                           emb.double())
    del model64
    harvest_err, stream_err = [], []
    for u in range(len(PRECISION)):
        for a, b in zip(io[u], io64[u]):
            harvest_err.append(float((a.double() - b).abs().max())
                               / max(float(b.abs().max()), 1e-30))
        bf = harvest_unit_io(model, params, "hnerv", spec, emb, only=u,
                             cache_dtype=torch.bfloat16)[u]
        for a, b in zip(bf, io[u]):
            # in bf16 units of the fp32 value: 2^(e - 8) for |b| in
            # [2^(e-1), 2^e)
            unit = torch.ldexp(torch.ones_like(b), torch.frexp(b)[1] - 8)
            stream_err.append(float(((a.float() - b.to(torch.bfloat16)
                                      .float()).abs() / unit).max()))
        del bf
    del io64
    print(f"  fp32 harvest ({shared_s:.3f} s) against float64, per unit "
          f"input / output max|diff| / max|value|: "
          f"{' '.join(f'{e:.2e}' for e in harvest_err)} (tol "
          f"{CONV_TOL:.0e}); the bf16 stream cache against it cast to "
          f"bf16, in bf16 units: {' '.join(f'{e:g}' for e in stream_err)} "
          f"(tol 1)")
    assert max(harvest_err) <= CONV_TOL, harvest_err
    assert max(stream_err) <= 1.0, stream_err
    out.update(harvest_rel_err_float64=harvest_err,
               stream_bf16_units=stream_err, shared_harvest_s=shared_s,
               cache_bytes={u: sum(t.numel() * t.element_size() for t in p)
                            for u, p in io.items()})

    _section("unit scope: block 4's step against float64 and on pallas")
    big = len(PRECISION) - 2           # block 4: 44 -> 37*4, 5x5
    idx = torch.tensor([1, 6], device=dev)
    count = 1           # in the warmup: the loss is the reconstruction's
    steps = {}
    for opt_mode in ("mse", "fisher_diag"):
        prob = UnitProblem(model, params, spec, state, big, emb,
                           iters=UNIT_ITERS, warmup=0.2, opt_mode=opt_mode,
                           io=io, log_fn=lambda m: None)
        loss32, g32, _ = _unit_step(prob, idx, count)
        loss64, g64, _ = _unit_step(prob, idx, count, torch.float64)
        rel = abs(loss32 - loss64) / abs(loss64)
        gerr = {k: float((g32[k] - g64[k]).abs().max())
                / max(float(g64[k].abs().max()), 1e-30) for k in g64}
        prob_fq = UnitProblem(model, params, spec_fq, state, big, emb,
                              iters=UNIT_ITERS, warmup=0.2,
                              opt_mode=opt_mode, io=io,
                              log_fn=lambda m: None)
        tr = prob.trainable()
        with torch.no_grad():
            wq_j = prob.fake_quant(tr)[0]
            wq_p = prob_fq.fake_quant(tr)[0]
        fq_err = float((wq_p - wq_j).abs().max()) / float(wq_j.abs().max())
        tf.reset_launch_counts()
        loss_p, g_p, _ = _unit_step(prob_fq, idx, count)
        fq_launches = dict(tf.KERNEL_LAUNCHES)
        rel_p = abs(loss_p - loss32) / abs(loss32)
        gerr_p = {k: float((g_p[k] - g32[k]).abs().max())
                  / max(float(g32[k].abs().max()), 1e-30) for k in g32}
        print(f"  block 4 ({tuple(prob.x_fp.shape)} -> "
              f"{tuple(prob.y_fp.shape)}), {opt_mode}: loss {loss32:.8e} "
              f"against float64 {loss64:.8e} (rel {rel:.2e}, tol "
              f"{LOSS_TOL:.0e}); alpha gradients against float64 "
              f"{gerr} (tol {GRAD_TOL:.0e}); fq_impl pallas: weights "
              f"{fq_err:.2e} of the largest from jnp's (tol {FQ_TOL:.0e}), "
              f"loss rel {rel_p:.2e} (tol {FQ_LOSS_TOL:.0e}), gradients "
              f"{gerr_p} (tol {FQ_GRAD_TOL:.0e}); launches {fq_launches}")
        assert rel <= LOSS_TOL, (loss32, loss64)
        assert max(gerr.values()) <= GRAD_TOL, gerr
        assert fq_err <= FQ_TOL, fq_err
        assert rel_p <= FQ_LOSS_TOL, (loss_p, loss32)
        assert max(gerr_p.values()) <= FQ_GRAD_TOL, gerr_p
        assert fq_launches["fq_ada"] == 1 and fq_launches["fq_ada_bwd"] == 1
        steps[opt_mode] = dict(loss=loss32, float64_loss=loss64,
                               loss_rel_err=rel, grad_rel_err=gerr,
                               fq_pallas=dict(weight_rel_err=fq_err,
                                              loss_rel_err=rel_p,
                                              grad_rel_err=gerr_p))
        del prob, prob_fq
    out["block4_step"] = steps

    _section("unit scope: each unit's step, both fq_impls")
    records = {}
    for u, name in enumerate(spec.layer_names):
        for label, sp in (("jnp", spec), ("pallas", spec_fq)):
            prob = UnitProblem(model, params, sp, state, u, emb,
                               iters=UNIT_ITERS, warmup=0.2, io=io,
                               log_fn=lambda m: None)
            rec = _unit_records(torch, tf, prob)
            want = ({"fq_ada": 1.0, "fq_ada_bwd": 1.0} if label == "pallas"
                    else {})
            assert rec["launches_per_step"] == want, rec
            assert rec["host_syncs_per_chunk"] == 1, rec
            records[f"{u} {label}"] = dict(rec, unit=name)
            idle = rec["idle_share"]
            print(f"  unit {u} ({name}) {label}: {rec['ms']:.3f} ms a step "
                  f"(batch {CALIB_BATCH}, {UNIT_TIMED_STEPS} back to back); "
                  f"busy {rec['busy_ms_per_step']} ms a step, idle "
                  f"{'not measured' if idle is None else f'{idle:.3f}'}; "
                  f"{rec['device_kernels_per_step']:.1f} device kernels and "
                  f"port launches {rec['launches_per_step']} a step; "
                  f"{rec['host_syncs_per_chunk']} host synchronisation(s) "
                  f"a chunk of {rec['chunk_steps']}")
            if (rec["busy_ms_per_step"] or 0) > 1.0:
                for r in rec["top"]:
                    print(f"    {r['ms']:8.4f} ms  x{r['launches']:<5g} "
                          f"{r['name'][:90]}")
            del prob
    out["steps"] = records
    _section()
    out["seconds"] = time.time() - t_start
    print(f"  phase 15 (unit scope) took {out['seconds']:.1f} s; card {card}")
    return out


DP_STEPS = 8         # phase 16: network-calibration and stage-1 steps
LANDSCAPE_GRID = 11  # phase 17: loss_landscape's default 11x11 surface
LANDSCAPE_LINE = 21  # and a 21-point line
LANDSCAPE_BATCH = 4
BENCH_ITERS = 264    # phase 18: 4 phase-2 epochs of 66 steps


def _dp_steps(mesh, work, frames_dir, pth, stage1_cfg, fq_impl, stage1,
              arch="hnerv", calib_extra=(), stage1_extra=()):
    """Phase 16's run on one data-parallel rank (`mesh`) or in one process
    (None): ``calibrate_network.run`` of HNeRV for DP_STEPS phase-2 steps
    at batch 2 (--fq_impl `fq_impl`; None: none) and, with `stage1`,
    ``regress.run`` of `arch` for DP_STEPS steps at batch 2; each step's
    loss (this rank's share: the ranks' sum is the step's), the calibrated
    state, the trained weights, this rank's launches; ms a calibration step
    (the median from the third step on, the recorder synchronising at each
    step) and a stage-1 step (rank 0's last Time/epoch line). The function
    each rank of ``--mesh_devices`` runs, with a recorder around the
    loss. `calib_extra`, `stage1_extra`: more flags for either CLI (phase
    19's bf16 ones)."""
    import torch

    from neuroquant_tpu_torch.methods import calibrate_network, regress
    from neuroquant_tpu_torch.ops import tail_fused as tf
    from neuroquant_tpu_torch.quantization import calibrate as tcal

    calib_losses, stage1_losses, stamps = [], [], []
    make_loss, make_epoch = tcal.make_loss, regress.make_train_epoch

    def recording_loss(*a, **k):
        fn = make_loss(*a, **k)

        def loss(*args, **kw):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            out = fn(*args, **kw)
            calib_losses.append(out[0].detach())
            return out
        return loss

    def recording_epoch(*a, **k):
        run = make_epoch(*a, **k)

        def run_epoch(*ra, **rk):
            losses, psnrs = run(*ra, **rk)
            stage1_losses.append(losses.detach())
            return losses, psnrs
        return run_epoch

    tag = ("one" if mesh is None else f"dp{mesh.size}") + (
        "_extra" if calib_extra or stage1_extra else "")
    cwd = os.getcwd()
    cap = _Capture()
    out = {}
    try:
        tcal.make_loss = recording_loss
        regress.make_train_epoch = recording_epoch
        os.chdir(work)
        logging.getLogger().addHandler(cap)
        before = dict(tf.KERNEL_LAUNCHES)
        if fq_impl is not None:
            _, state, _ = calibrate_network.run(mesh, [
                "--config", os.path.join(REPO, HNERV_CONFIG), "--arch",
                "hnerv", "--data_path", frames_dir, "--vid", "Bunny",
                "--outf", f"dp_calib_{fq_impl}_{tag}", "--ckpt", pth,
                "--precision", *map(str, PRECISION), "--hadamard",
                "--channel_wise", "--batch_size", str(CALIB_BATCH),
                "--iters_w", str(DP_STEPS), "--lr", "0.003", "--warmup",
                "0.2", "--fq_impl", fq_impl, "--calib_ckpt_freq", "0",
                *calib_extra])
            out["state"] = {ln: {k: v.detach().cpu() for k, v in s.items()}
                            for ln, s in state.items()}
        if stage1:
            model = regress.run(mesh, [
                "--config", stage1_cfg, "--arch", arch, "--data_path",
                frames_dir, "--vid", "Bunny", "--outf",
                f"dp_stage1_{arch}_{tag}", *stage1_extra])
            out["weights"] = {k: v.detach().cpu()
                              for k, v in model.state_dict().items()}
        torch.cuda.synchronize()
        out["launches"] = {k: n - before[k]
                           for k, n in tf.KERNEL_LAUNCHES.items()}
    finally:
        tcal.make_loss, regress.make_train_epoch = make_loss, make_epoch
        logging.getLogger().removeHandler(cap)
        os.chdir(cwd)
    out["calib_losses"] = [float(x) for x in calib_losses]
    out["stage1_losses"] = [float(x) for t in stage1_losses for x in t]
    epoch_s = re.findall(r"Time/epoch: \tCurrent:([\d.]+)",
                         "\n".join(cap.lines))
    out["calib_ms_per_step"] = (1e3 * float(np.median(np.diff(stamps)[1:]))
                                if stamps else None)
    # the last epoch's time over its steps (8 frames at batch 2)
    out["stage1_ms_per_step"] = (1e3 * float(epoch_s[-1])
                                 / (N_FRAMES // CALIB_BATCH)
                                 if epoch_s else None)
    return out


def _leaf_err(got, want):
    """max |got - want| / max |want| over the leaves of two flat dicts."""
    return max(float((got[k].double() - w.double()).abs().max())
               / max(float(w.abs().max()), 1e-30) for k, w in want.items())


def _state_leaves(state):
    return {f"{ln}/{k}": v for ln, s in state.items() for k, v in s.items()}


def _dp_phase(torch, tf, sd, frames_dir, card, work):
    """Phase 16: data parallelism at HNeRV Bunny-3M, full width and depth,
    on the 8 seeded frames, from a .pth of the seeded weights: DP_STEPS
    network-calibration steps at batch 2 (both fq_impls) and DP_STEPS
    stage-1 steps at batch 2, in one process, then (a) through the rank
    function the CLIs spawn at world size 1 over NCCL, held bitwise to the
    one-process run (one rank's all-reduce is the identity; cuDNN held to
    its deterministic algorithms for both), and (b) on two ranks that
    share cuda:0 over gloo (a harness arrangement: the CLIs put rank r on
    cuda:r over NCCL, and this machine has one card), one frame a rank,
    held to the one-process run (each step's loss LOSS_TOL, every leaf
    GRAD_TOL of its largest), both ranks ending with the same weights and
    state, each rank launching the step kernels; (c) likewise DP_STEPS
    stage-1 steps of PNeRV1 Bunny-3M from its seed (fp32 fusion stages),
    whose shortcuts' batch norm sums its statistics over the two ranks.
    ms a step of each; (b)'s and (c)'s are two processes sharing one card,
    not a speed-up figure."""
    import yaml

    from neuroquant_tpu_torch.config import get_config
    from neuroquant_tpu_torch.parallel.mesh import (
        _free_port, launch, run_rank)

    t_start = time.time()
    pth = os.path.join(work, "hnerv_seeded.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    stage1_cfg = os.path.join(work, "hnerv_dp_stage1.yaml")
    with open(stage1_cfg, "w") as f:
        # 8 frames at batch 2: two epochs of four steps, one eval
        yaml.safe_dump(dict(get_config(os.path.join(REPO, HNERV_CONFIG)),
                            epoch=DP_STEPS * CALIB_BATCH // N_FRAMES,
                            batch_size=CALIB_BATCH), f)
    args = (work, frames_dir, pth, stage1_cfg)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tf.reset_launch_counts()
    try:
        _section("data parallel: one process")
        one = {"jnp": _dp_steps(None, *args, "jnp", True),
               "pallas": _dp_steps(None, *args, "pallas", False)}
        _section("data parallel (a): world size 1, NCCL, the CLIs' rank "
                 "function")
        ws1 = {fq: run_rank(0, 1, "cuda:0", "nccl",
                            f"tcp://127.0.0.1:{_free_port()}", _dp_steps,
                            args + (fq, fq == "jnp"))
               for fq in ("jnp", "pallas")}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = dict(tf.KERNEL_LAUNCHES)
    for fq in ("jnp", "pallas"):
        a, b = _state_leaves(one[fq]["state"]), _state_leaves(
            ws1[fq]["state"])
        same = all(torch.equal(a[k], b[k]) for k in a)
        print(f"  (a) calibrate_network --fq_impl {fq}, {DP_STEPS} steps at "
              f"batch {CALIB_BATCH}: world size 1 against one process "
              f"{'bitwise equal' if same else 'DIFFERENT'} ({len(a)} "
              f"leaves); losses {one[fq]['calib_losses']} / "
              f"{ws1[fq]['calib_losses']}; ms a step "
              f"{ws1[fq]['calib_ms_per_step']:.2f} (one process "
              f"{one[fq]['calib_ms_per_step']:.2f}; steps 3-{DP_STEPS}, "
              f"synchronised); card {card}")
        assert same, fq
        assert one[fq]["calib_losses"] == ws1[fq]["calib_losses"], fq
    w1, w0 = ws1["jnp"]["weights"], one["jnp"]["weights"]
    same = all(torch.equal(w1[k], w0[k]) for k in w0)
    verdict = "bitwise equal" if same else "DIFFERENT"
    print(f"  (a) regress, {DP_STEPS} steps at batch {CALIB_BATCH}: world "
          f"size 1 against one process {verdict} ({len(w0)} tensors); losses "
          f"{one['jnp']['stage1_losses']}; ms a step (the second epoch) "
          f"{ws1['jnp']['stage1_ms_per_step']:.2f} (one process "
          f"{one['jnp']['stage1_ms_per_step']:.2f}); card {card}")
    assert same and one["jnp"]["stage1_losses"] == ws1["jnp"][
        "stage1_losses"]

    _section("data parallel (b): two ranks on cuda:0 over gloo")
    t0 = time.time()
    ranks = launch(_dp_steps, 2, "cuda", args + ("pallas", True),
                   devices=["cuda:0", "cuda:0"])
    wall_b = time.time() - t0
    ref = one["pallas"]
    calib = [a + b for a, b in zip(ranks[0]["calib_losses"],
                                   ranks[1]["calib_losses"])]
    stage1 = ranks[0]["stage1_losses"]
    assert len(calib) == len(ref["calib_losses"]) == DP_STEPS
    assert len(stage1) == DP_STEPS and stage1 == ranks[1]["stage1_losses"]
    loss_err = max(abs(g - w) / abs(w) for g, w in zip(
        calib + stage1, ref["calib_losses"] + one["jnp"]["stage1_losses"]))
    state_err = _leaf_err(_state_leaves(ranks[0]["state"]),
                          _state_leaves(ref["state"]))
    weight_err = _leaf_err(ranks[0]["weights"], one["jnp"]["weights"])
    same_ranks = (all(torch.equal(ranks[0]["weights"][k],
                                  ranks[1]["weights"][k])
                      for k in ranks[0]["weights"])
                  and all(torch.equal(v, _state_leaves(ranks[1]["state"])[k])
                          for k, v in _state_leaves(ranks[0]["state"]).items()))
    print(f"  (b) two ranks, one frame each: each step's loss against one "
          f"process {loss_err:.2e} (tol {LOSS_TOL:.0e}); calibrated state "
          f"{state_err:.2e}, trained weights {weight_err:.2e} of a leaf's "
          f"largest (tol {GRAD_TOL:.0e}); the ranks end "
          f"{'identical' if same_ranks else 'DIFFERENT'}; {wall_b:.1f} s "
          f"wall with the two processes' start")
    for r, rk in enumerate(ranks):
        print(f"  (b) rank {r}: launches {rk['launches']}; ms a "
              f"calibration step {rk['calib_ms_per_step']:.2f}"
              + ("" if rk["stage1_ms_per_step"] is None else
                 f", a stage-1 step {rk['stage1_ms_per_step']:.2f}")
              + " (two processes sharing one card over gloo: not a "
              f"speed-up figure); card {card}")
        for k in ("tail_conv_cf", "tail_conv_dw_cf", "pack_cf", "unpack_cf",
                  "fq_ada", "fq_ada_bwd"):
            assert rk["launches"][k] > 0, (r, k)
    assert loss_err <= LOSS_TOL, loss_err
    assert state_err <= GRAD_TOL and weight_err <= GRAD_TOL, (state_err,
                                                              weight_err)
    assert same_ranks

    _section("data parallel (c): PNeRV1 stage 1, two ranks on cuda:0, its "
             "batch norm over both")
    pnerv_cfg = os.path.join(work, "pnerv_dp_stage1.yaml")
    with open(pnerv_cfg, "w") as f:
        # fp32 fusion stages, so that one process and the ranks differ by
        # the order of the sums only
        yaml.safe_dump(dict(get_config(os.path.join(REPO, PNERV_CONFIG)),
                            epoch=DP_STEPS * CALIB_BATCH // N_FRAMES,
                            batch_size=CALIB_BATCH, bsm_dtype="float32",
                            workers=0), f)
    pargs = (work, frames_dir, None, pnerv_cfg, None, True, "pnerv")
    p_one = _dp_steps(None, *pargs)
    p_ranks = launch(_dp_steps, 2, "cuda", pargs,
                     devices=["cuda:0", "cuda:0"])
    p_losses = p_ranks[0]["stage1_losses"]
    assert len(p_losses) == DP_STEPS
    p_loss_err = max(abs(g - w) / abs(w)
                     for g, w in zip(p_losses, p_one["stage1_losses"]))
    p_weight_err = _leaf_err(p_ranks[0]["weights"], p_one["weights"])
    p_same = all(torch.equal(p_ranks[0]["weights"][k],
                             p_ranks[1]["weights"][k])
                 for k in p_ranks[0]["weights"])
    print(f"  (c) PNeRV1 regress, {DP_STEPS} steps at batch {CALIB_BATCH}, "
          f"one frame a rank, the shortcuts' batch norm over both: each "
          f"step's loss against one process {p_loss_err:.2e} (tol "
          f"{LOSS_TOL:.0e}); trained weights {p_weight_err:.2e} of a leaf's "
          f"largest (tol {GRAD_TOL:.0e}); the ranks end "
          f"{'identical' if p_same else 'DIFFERENT'}; ms a step "
          f"{p_ranks[0]['stage1_ms_per_step']:.2f} (one process "
          f"{p_one['stage1_ms_per_step']:.2f}; two processes sharing one "
          f"card); card {card}")
    for r, rk in enumerate(p_ranks):
        print(f"  (c) rank {r}: launches {rk['launches']}")
        for k in ("tail_conv_cf", "tail_conv_dw_cf", "pack_cf",
                  "unpack_cf"):
            assert rk["launches"][k] > 0, (r, k)
    assert p_loss_err <= LOSS_TOL, p_loss_err
    assert p_weight_err <= GRAD_TOL, p_weight_err
    assert p_same
    _section()
    seconds = time.time() - t_start
    print(f"  phase 16 (data parallel) took {seconds:.1f} s; card {card}")
    return dict(seconds=seconds, launches=launches,
                rank_launches=[r["launches"] for r in ranks],
                loss_rel_err=loss_err, state_rel_err=state_err,
                weight_rel_err=weight_err, two_rank_wall_s=wall_b,
                pnerv_loss_rel_err=p_loss_err,
                pnerv_weight_rel_err=p_weight_err,
                pnerv_rank_launches=[r["launches"] for r in p_ranks],
                ms_per_step={
                    "one_process": {fq: one[fq]["calib_ms_per_step"]
                                    for fq in one},
                    "one_process_stage1": one["jnp"]["stage1_ms_per_step"],
                    "ws1": {fq: ws1[fq]["calib_ms_per_step"] for fq in ws1},
                    "ws1_stage1": ws1["jnp"]["stage1_ms_per_step"],
                    "ws2_gloo_shared_card": [r["calib_ms_per_step"]
                                             for r in ranks],
                    "ws2_gloo_shared_card_stage1": ranks[0][
                        "stage1_ms_per_step"],
                    "pnerv_one_process_stage1": p_one["stage1_ms_per_step"],
                    "pnerv_ws2_gloo_shared_card_stage1": p_ranks[0][
                        "stage1_ms_per_step"]})


def _landscape_phase(torch, tf, cfg, sd, frames_dir, card):
    """Phase 17: loss_landscape at HNeRV Bunny-3M, full width and depth:
    compute_surface on the default 11x11 grid at --batch 4 and
    compute_line on 21 points, one decode on the kernels a point (its
    launches counted: 4 / 2 / 1 a decode); three points of each held to
    the plain unpacked decode (fused_tail: off) at the same weights, the
    frames within DECODE_TOL and the loss within 2 * DECODE_TOL (an MSE of
    frames in [0, 1] moves at most twice the largest frame difference);
    the surface not constant; seconds a point. The compute functions are
    called directly (no h5, no plot)."""
    from neuroquant_tpu_torch.analysis import loss_landscape as ll
    from neuroquant_tpu_torch.data import VideoDataSet
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.quantization.spec import make_spec
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    t_start = time.time()
    params = state_dict_from_numpy(sd, "cuda")
    data = VideoDataSet(cfg, frames_dir, device="cuda")
    models = {}
    for ft in ("auto", "off"):
        models[ft] = build_model("hnerv", dict(cfg, fused_tail=ft),
                                 device="cuda")
        models[ft].load_state_dict(params, strict=True)
        models[ft].eval()
    model = models["auto"]
    keys = [f"{pre}.weight" for pre in make_spec("hnerv", cfg).layer_keys]
    centre = [params[k].permute(2, 3, 1, 0) for k in keys]
    gen = torch.Generator().manual_seed(123)
    d1 = ll.filter_normalized_direction(gen, centre)
    d2 = ll.filter_normalized_direction(gen, centre)
    xs = ys = np.linspace(-1, 1, LANDSCAPE_GRID)
    line_xs = np.linspace(-1, 1, LANDSCAPE_LINE)
    batch_idx = np.arange(LANDSCAPE_BATCH)
    torch.cuda.synchronize()
    tf.reset_launch_counts()
    t0 = time.time()
    surface = ll.compute_surface(model, keys, data.frames, data.norm_idx,
                                 xs, ys, batch_idx, dirs=(d1, d2))
    torch.cuda.synchronize()
    t_surface = time.time() - t0
    t0 = time.time()
    losses, psnr = ll.compute_line(model, keys, data.frames, data.norm_idx,
                                   line_xs, batch_idx, dirs=d1)
    torch.cuda.synchronize()
    t_line = time.time() - t0
    launches = dict(tf.KERNEL_LAUNCHES)
    n_points = LANDSCAPE_GRID ** 2 + LANDSCAPE_LINE
    want = {k: n * n_points for k, n in PER_DECODE.items()}
    assert launches == want, (launches, want)
    assert np.isfinite(surface).all() and np.isfinite(losses).all()
    spread = float(np.ptp(surface))
    assert spread > 1e-6 * float(surface.max()), surface
    img = data.frames[:LANDSCAPE_BATCH]
    with torch.no_grad():
        emb = model.encode(img)
    worst_frame = worst_loss = 0.0
    checks = [("surface", (i, j), (xs[i], ys[j]), (d1, d2), surface[i, j])
              for i, j in ((0, 0), (5, 5), (10, 3))]
    checks += [("line", (i,), (line_xs[i],), (d1,), losses[i])
               for i in (0, 10, 20)]
    for what, at, coeffs, dirs, got in checks:
        frames = {}
        for ft, m in models.items():
            named = dict(m.named_parameters())
            with torch.no_grad():
                for n, (k, w) in enumerate(zip(keys, centre)):
                    v = w
                    for c, dd in zip(coeffs, dirs):
                        v = v + float(c) * dd[n]
                    named[k].copy_(v.permute(3, 2, 0, 1))
                frames[ft] = m.decode(emb)
        frame_err = float((frames["auto"] - frames["off"]).abs().max())
        plain = float(torch.mean((frames["off"] - img) ** 2))
        worst_frame = max(worst_frame, frame_err)
        worst_loss = max(worst_loss, abs(got - plain))
        print(f"  {what} point {at}: loss {got:.6e} on the kernels, "
              f"{plain:.6e} on the plain decode; frames "
              f"{frame_err:.2e} apart (tol {DECODE_TOL:.0e})")
    for m in models.values():
        m.load_state_dict(params, strict=True)
    assert worst_frame <= DECODE_TOL, worst_frame
    assert worst_loss <= 2 * DECODE_TOL, worst_loss
    per_point = (t_surface + t_line) / n_points
    print(f"  surface {LANDSCAPE_GRID}x{LANDSCAPE_GRID} at batch "
          f"{LANDSCAPE_BATCH}: {t_surface:.2f} s, loss {surface.min():.6e}"
          f"-{surface.max():.6e}; line {LANDSCAPE_LINE} points: "
          f"{t_line:.2f} s, PSNR {psnr.min():.3f}-{psnr.max():.3f} dB; "
          f"{per_point:.4f} s a point; launches {launches} "
          f"({n_points} decodes x {PER_DECODE['tail_conv_cf']} / "
          f"{PER_DECODE['pack_cf']} / {PER_DECODE['unpack_frames']}); card "
          f"{card}")
    seconds = time.time() - t_start
    print(f"  phase 17 (loss landscape) took {seconds:.1f} s; card {card}")
    return dict(seconds=seconds, launches=launches, s_per_point=per_point,
                surface_s=t_surface, line_s=t_line, points=n_points,
                surface_min=float(surface.min()),
                surface_max=float(surface.max()),
                worst_frame_err=worst_frame, worst_loss_err=worst_loss)


def _bench_phase(card):
    """Phase 18: ``python -m neuroquant_tpu_torch.bench --iters
    BENCH_ITERS`` in its own process: its one JSON line, printed here
    (never as the last line), with its it/s and decode FPS."""
    t0 = time.time()
    run = subprocess.run(
        [sys.executable, "-m", "neuroquant_tpu_torch.bench", "--iters",
         str(BENCH_ITERS)], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    seconds = time.time() - t0
    if run.returncode != 0:
        print(run.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"the bench exited {run.returncode}")
    lines = run.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    result = json.loads(lines[0])
    print(lines[0])
    assert result["metric"] == "hnerv_bunny_network_calib_throughput"
    assert result["value"] > 0 and result["decode_fps_per_chip"] > 0
    print(f"  bench --iters {BENCH_ITERS}: {result['value']:.2f} it/s "
          f"(median of phase-2 epochs "
          f"{[round(r, 2) for r in result['steady_epoch_rates']]}), decode "
          f"{result['decode_fps_per_chip']:.1f} FPS at batch 1, {seconds:.1f} "
          f"s in all; card {result['card']} (this run's card: {card})")
    return dict(result, seconds=seconds)


def _bf16_units(torch, got, want):
    """Per element, |got - want| over the bf16 spacing at the element (the
    larger of the two values' spacings: 2^-7 of the power of two at or
    below each)."""
    def spacing(t):
        _, e = torch.frexp(t.float())
        return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)
    return ((got.float() - want.float()).abs()
            / torch.maximum(spacing(got), spacing(want)))


def _bf16_bound(nbytes: float, flops: float):
    """The bound of a bf16 kernel: bf16 FLOPs at the dense tensor-core
    peak, or its bytes at the memory rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _bf16_kernel_phase(torch, tf, cfg, model):
    """Phase 19's kernels: each bf16 instantiation at HNeRV Bunny-3M's
    shapes against its plain version on the card: the decode's convs at
    batch 1 (the emits and act_in a decode and a step use), a calibration
    step's forward, dx and dW passes at batch 2, pack_cf's two entries
    from fp32 (the bf16 matmul precision's entry) at batch 1 and from bf16
    (a bf16 calibration's) at batch 2, unpack_cf back to bf16 and to fp32
    at batch 2, unpack_frames to fp32 and to bf16 frames and on the
    width-tiled plan; pack_cf and unpack_frames also from inputs 1, 3 and
    7 elements past a 16-byte boundary; pack_cf and unpack_cf also at PNeRV
    Bunny-3M's c = 100 entry, unpack_frames at its 16-row sigmoid head
    (outside the sums). A conv's bf16
    output within one bf16 unit of each element beyond CONV_TOL of the
    largest (the fp32 sums' other order), the share of elements that
    differ printed; dW and db within 1e-5 of the largest (exact products,
    fp32 sums in another order); the layout kernels bit for bit,
    unpack_frames' bf16 frames within one unit and its fp32 frames 1e-6.
    Each timed beside its plain version, its bound (bf16 FLOPs at 989
    TFLOP/s or bf16 bytes at 3.35 TB/s) and the cuDNN / PyTorch call of
    the same function in bf16: CUDA events back to back and, for the
    convs, the profiler's device time; for the layout kernels the card's
    own time by the event method, hot and cold (``hot_cold`` of
    ``neuroquant_tpu_torch.utils.profiling``; None where the host set the
    pace, and then the kernels line's sum of that reading is None too)."""
    import torch.nn.functional as F

    bf = torch.bfloat16
    dev = torch.device("cuda")
    convs, pplan, plan, f, ch, entries = _conv_layers(torch, tf, cfg, model)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    records = {k: {"per_launch": [], "max_abs_err": 0.0, "checks": []}
               for k in BF16_KERNELS}

    def check_conv(kname, what, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        units, differ, n, err = 0.0, 0, 0, 0.0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == bf, (a.dtype, b.dtype)
            allow = CONV_TOL * max(1.0, float(b.float().abs().max()))
            diff = (a.float() - b.float()).abs()
            u = _bf16_units(torch, a, b)
            beyond = u[diff > allow]
            units = max(units, float(beyond.max()) if beyond.numel() else 0)
            differ += int((diff > 0).sum())
            n += diff.numel()
            err = max(err, float(diff.max()))
        print(f"  {kname} bf16 {what}: max_abs_err {err:.3e}, "
              f"{100 * differ / n:.4f}% of the elements differ, the largest "
              f"{units:.2f} bf16 units beyond {CONV_TOL:.0e} of the largest "
              f"(tol 1)")
        assert units <= 1.0, (kname, what, units)
        records[kname]["max_abs_err"] = max(records[kname]["max_abs_err"],
                                            err)
        records[kname]["checks"].append(dict(what=what, max_abs_err=err,
                                             differ_share=differ / n,
                                             units=units))

    def check_close(kname, what, got, want, rel):
        err = float((got.float() - want.float()).abs().max())
        tol = rel * float(want.float().abs().max())
        print(f"  {kname} bf16 {what}: max_abs_err {err:.3e} (tol "
              f"{tol:.1e})")
        assert err <= tol, (kname, what, err, tol)
        records[kname]["max_abs_err"] = max(records[kname]["max_abs_err"],
                                            err)

    def f4(v):
        return "not measured" if v is None else f"{v:.4f}"

    def record(kname, shape, fn, plain, lib, nbytes, flops, key="per_launch"):
        ms = _time_ms(fn, iters=10)
        plain_ms = _time_ms(plain, iters=3, warmup=1)
        lib_ms = _time_ms(lib, iters=10)
        bound_ms, by = _bf16_bound(nbytes, flops)
        rec = dict(shape=shape, ms=ms, device_ms=_device_ms(fn),
                   plain_ms=plain_ms, library_ms=lib_ms,
                   library_device_ms=_device_ms(lib), bound_ms=bound_ms,
                   bound_by=by, gflop=flops / 1e9, mbytes=nbytes / 1e6)
        if flops:
            # the conv kernels' useful rate against cuDNN's bf16 call's
            rec.update(tflops=flops / ms / 1e9,
                       library_tflops=flops / lib_ms / 1e9)
        records[kname].setdefault(key, []).append(rec)
        print(f"  {kname} bf16 {shape}: {ms:.4f} ms back to back, "
              f"{f4(rec['device_ms'])} on the device (plain {plain_ms:.4f}; "
              f"library {lib_ms:.4f}, {f4(rec['library_device_ms'])} on the "
              f"device; bound {bound_ms:.4f} by {by}"
              + (f"; {rec['tflops']:.1f} TFLOP/s, cuDNN's bf16 "
                 f"{rec['library_tflops']:.1f}" if flops else "") + ")")

    def cf(p, c, b):
        return _cf_input(torch, tf, p, c, gen, b).to(bf)

    def seeded(shape, dtype):
        """make(i): random values of `shape` and `dtype` from seed i"""
        def make(i):
            g = torch.Generator(device=dev).manual_seed(SEED + 1900 + i)
            return torch.randn(shape, generator=g, device=dev).to(dtype)
        return make

    def off_by(t, off):
        """a copy of t that starts `off` elements past a 16-byte boundary"""
        buf = torch.empty(t.numel() + off, dtype=t.dtype, device=dev)
        view = buf[off:].view(t.shape)
        view.copy_(t)
        return view

    def layout(kname, shape, make, run, plain, lib_make, lib, library,
               nbytes, lib_nbytes, key):
        """A layout kernel's row: back-to-back ms (host-paced), the card's
        own time hot and cold by the event method (None where the host set
        the pace), for the wrapper and for the library call (named, with
        its bytes); the plain version's ms; the bound by bytes."""
        from neuroquant_tpu_torch.utils.profiling import hot_cold

        x, xl = make(0), lib_make(0)
        hot, cold = hot_cold(make, run, nbytes)
        lhot, lcold = hot_cold(lib_make, lib, lib_nbytes)
        bound_ms, by = _bf16_bound(nbytes, 0)
        rec = dict(shape=shape, ms=_time_ms(lambda: run(x), iters=10),
                   hot_ms=hot, cold_ms=cold,
                   plain_ms=_time_ms(lambda: plain(x), iters=3, warmup=1),
                   library=library,
                   library_ms=_time_ms(lambda: lib(xl), iters=10),
                   library_hot_ms=lhot, library_cold_ms=lcold,
                   bound_ms=bound_ms, bound_by=by,
                   mbytes=nbytes / 1e6, library_mbytes=lib_nbytes / 1e6)
        records[kname].setdefault(key, []).append(rec)
        print(f"  {kname} bf16 {shape}: {rec['ms']:.4f} ms back to back, "
              f"on the card {f4(hot)} hot / {f4(cold)} cold (plain "
              f"{rec['plain_ms']:.4f}; library {rec['library_ms']:.4f}, "
              f"{f4(lhot)} / {f4(lcold)}, {library}, "
              f"{lib_nbytes / 1e6:.2f} MB; bound {bound_ms:.4f} by {by}, "
              f"{nbytes / 1e6:.2f} MB)")

    # PNeRV Bunny-3M's post-fusion tail: its c = 100 entry, its 16-row
    # sigmoid head at f = 2
    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.models import tail_plan_for

    pcfg = validate_config(get_config(os.path.join(REPO, PNERV_CONFIG)),
                           "pnerv")
    nplan, nf, nch = tail_plan_for("pnerv", pcfg)
    nc = int(pcfg["kfc_h_w_c"][2])

    with torch.no_grad():
        # the decode's convs at batch 1, and a calibration step's at batch 2
        for name, p, layer, kk32, bias32, cin, cout, lib in convs:
            kk = kk32.to(bf)
            bias = None if bias32 is None else bias32.to(bf)
            xs, ws, pad = lib
            w_op = tf.conv_w_operand(kk, p, layer)
            x1 = cf(p, layer.cin, 1)
            for em, act in (("z", False), ("y", False), ("zy", False),
                            ("z", True)):
                check_conv("tail_conv_cf", f"{name} batch 1 emit={em} "
                           f"act_in={act}",
                           tf.conv_cf(x1, kk, bias, p, layer, em, act, w_op),
                           tf.conv_cf_ref(x1, kk, bias, p, layer, em, act))
            emit = "y" if name.startswith("tail") else "z"
            flops = tf.conv_cf_flops(p, layer, 1, cin, cout)
            xl = torch.randn(xs, generator=gen, device=dev).to(bf)
            wl = (torch.randn(ws, generator=gen, device=dev) * 0.05).to(bf)
            record("tail_conv_cf", f"{name} {layer.cin}->{layer.cout} "
                   f"k{layer.side} grid {p.h}x{p.w} batch 1 emit={emit}",
                   lambda: tf.conv_cf(x1, kk, bias, p, layer, emit,
                                      w_op=w_op),
                   lambda: tf.conv_cf_ref(x1, kk, bias, p, layer, emit),
                   lambda: F.conv2d(xl, wl, padding=pad),
                   2 * (x1.numel() + kk.numel() + layer.cout
                        + layer.cout * p.mp), flops)
            B = CALIB_BATCH
            x, g = cf(p, layer.cin, B), cf(p, layer.cout, B)
            xl2 = torch.randn((B, *xs[1:]), generator=gen, device=dev).to(bf)
            gl2 = torch.randn((B, ws[0], *xs[2:]), generator=gen,
                              device=dev).to(bf)
            flops = tf.conv_cf_flops(p, layer, B, cin, cout)
            geo = (f"{name} {layer.cin}->{layer.cout} k{layer.side} grid "
                   f"{p.h}x{p.w} batch {B}")
            emit = "zy" if name.startswith("tail") else "z"
            check_conv("tail_conv_cf", f"forward {geo} emit={emit}",
                       tf.conv_cf(x, kk, bias, p, layer, emit, False, w_op),
                       tf.conv_cf_ref(x, kk, bias, p, layer, emit))
            record("tail_conv_cf", f"forward {geo} emit={emit}",
                   lambda: tf.conv_cf(x, kk, bias, p, layer, emit, False,
                                      w_op),
                   lambda: tf.conv_cf_ref(x, kk, bias, p, layer, emit),
                   lambda: F.conv2d(xl2, wl, padding=pad),
                   2 * (x.numel() + kk.numel() + layer.cout
                        + g.numel() * len(emit)), flops,
                   key="calibration_per_launch")
            lt = layer.transposed()
            kt = tf._kk_transpose(kk).contiguous()
            om = x if layer.gelu_in else None
            wt_op = tf.conv_w_operand(kt, p, lt)
            check_conv("tail_conv_cf", f"dx {geo} out_mul={om is not None}",
                       tf.conv_cf(g, kt, None, p, lt, w_op=wt_op, out_mul=om),
                       tf.conv_cf_ref(g, kt, None, p, lt, out_mul=om))
            record("tail_conv_cf", f"dx {geo}",
                   lambda: tf.conv_cf(g, kt, None, p, lt, w_op=wt_op,
                                      out_mul=om),
                   lambda: tf.conv_cf_ref(g, kt, None, p, lt, out_mul=om),
                   lambda: torch.nn.grad.conv2d_input(xl2.shape, wl, gl2,
                                                      padding=pad),
                   2 * (g.numel() + kt.numel()
                        + x.numel() * (2 if om is not None else 1)), flops,
                   key="calibration_per_launch")
            blocks = tf._k_blocks(p, layer)
            dkk, db = tf.conv_cf_dw(x, g, p, layer)
            rkk, rdb = tf.conv_cf_dw_ref(x, g, p, layer, False, blocks)
            check_close("tail_conv_dw_cf", f"dW {geo}", dkk, rkk, 1e-5)
            check_close("tail_conv_dw_cf", f"db {geo}", db, rdb, 1e-5)
            assert torch.equal(tf.conv_cf_dw(x, g, p, layer)[0], dkk)
            if layer.gelu_in:
                check_close("tail_conv_dw_cf", f"dW {geo} act_in=True",
                            tf.conv_cf_dw(x, g, p, layer, True)[0],
                            tf.conv_cf_dw_ref(x, g, p, layer, True,
                                              blocks)[0], 1e-5)
            record("tail_conv_dw_cf", f"dW {geo}",
                   lambda: tf.conv_cf_dw(x, g, p, layer),
                   lambda: tf.conv_cf_dw_ref(x, g, p, layer, False, blocks),
                   lambda: torch.nn.grad.conv2d_weight(xl2, wl.shape, gl2,
                                                       padding=pad),
                   2 * (x.numel() + g.numel()) + 4 * (dkk.numel()
                                                      + db.numel()), flops)

        # the entries: from fp32 at batch 1 (a decode under the bf16
        # precision), from bf16 at batch 2 (a bf16 calibration step), and
        # unpack_cf's cotangents at batch 2 back to bf16 and to fp32; each
        # also from inputs 1, 3 and 7 elements past a 16-byte boundary;
        # PNeRV's c = 100 entry beside them, outside the sums
        for batch, src, key in ((1, torch.float32, "per_launch"),
                                (CALIB_BATCH, bf, "calibration_per_launch")):
            for name, p, c in entries + (("PNeRV entry", nplan, nc),):
                shape = (batch, p.h, p.w, c)
                make = seeded(shape, src)
                x = make(0)
                out = tf.pack_cf(x, p, bf)
                assert out.dtype == bf
                assert torch.equal(out, tf.pack_cf_ref(x, p, bf)), name
                for off in (1, 3, 7):
                    xo = off_by(x, off)
                    assert torch.equal(tf.pack_cf(xo, p, bf),
                                       tf.pack_cf_ref(xo, p, bf)), (name, off)
                what = (f"{name} {shape} {str(src)[6:]} -> "
                        f"{tuple(out.shape)} bfloat16")
                print(f"  pack_cf bf16 {what}: bit for bit, also 1, 3 and 7 "
                      f"elements off 16 bytes")
                layout("pack_cf", what, make, lambda x, p=p: tf.pack_cf(
                           x, p, bf),
                       lambda x, p=p: tf.pack_cf_ref(x, p, bf),
                       seeded(shape, src),
                       (lambda x: x.permute(0, 3, 1, 2).contiguous())
                       if src is bf else
                       lambda x: x.permute(0, 3, 1, 2).to(
                           bf, memory_format=torch.contiguous_format),
                       "permute + cast, contiguous: no ring, no pad",
                       x.numel() * x.element_size() + 2 * out.numel(),
                       x.numel() * (x.element_size() + 2),
                       "pnerv_per_launch" if name.startswith("PNeRV")
                       else key)
        for dst in (bf, torch.float32):
            for name, p, c in entries + (("PNeRV entry", nplan, nc),):
                make = seeded((CALIB_BATCH, tf._r8(c), p.mp), bf)
                g = make(0)
                out = tf.unpack_cf(g, p, c, dst)
                assert out.dtype == dst
                assert torch.equal(out, tf.unpack_cf_ref(g, p, c, dst)), name
                lshape = (CALIB_BATCH, c, p.h, p.w)
                what = (f"{name} {tuple(g.shape)} bfloat16 -> "
                        f"{tuple(out.shape)} {str(dst)[6:]}")
                print(f"  unpack_cf bf16 {what}: bit for bit")
                layout("unpack_cf", what, make,
                       lambda g, p=p, c=c, dst=dst: tf.unpack_cf(g, p, c, dst),
                       lambda g, p=p, c=c, dst=dst: tf.unpack_cf_ref(
                           g, p, c, dst),
                       seeded(lshape, bf),
                       (lambda x: x.permute(0, 2, 3, 1).contiguous())
                       if dst is bf else
                       lambda x: x.permute(0, 2, 3, 1).to(
                           torch.float32,
                           memory_format=torch.contiguous_format),
                       "permute (+ cast), contiguous: a dense input",
                       2 * out.numel() + out.numel() * out.element_size(),
                       2 * out.numel() + out.numel() * out.element_size(),
                       "pnerv_per_launch" if name.startswith("PNeRV")
                       else "per_launch" if dst is bf
                       else "fp32_out_per_launch")

        ob = _out_bias(cfg)
        wplan, wf = tf.plan_geometry(4, 480, [(3, 17, 224, 4)], (3, 14, 3))
        for key, p, ff, cc, b, dst, obias in (
                ("per_launch", plan, f, ch, 1, torch.float32, ob),
                ("bf16_out_per_launch", plan, f, ch, 1, bf, ob),
                ("width_tiled", wplan, wf, 48, 2, torch.float32, "tanh"),
                ("pnerv_per_launch", nplan, nf, nch, 1, torch.float32,
                 "sigmoid"),
                ("pnerv_per_launch", nplan, nf, nch, 1, bf, "sigmoid")):
            make = seeded((b, p.layers[-1].cout, p.mp), bf)
            z = make(0)
            out = tf.unpack_frames(z, p, ff, cc, obias, dst)
            ref = tf.unpack_frames_ref(z, p, ff, cc, obias, dst)
            assert out.dtype == ref.dtype == dst
            what = (f"{tuple(z.shape)} bfloat16 -> {tuple(out.shape)} "
                    f"{str(dst)[6:]} out_bias={obias}")
            if dst is bf:
                check_conv("unpack_frames", what, out, ref)
            else:
                check_close("unpack_frames", what, out, ref,
                            1e-6 / max(float(ref.abs().max()), 1e-30))
            if key in ("per_launch", "bf16_out_per_launch"):
                for off in (1, 3, 7):
                    zo = off_by(z, off)
                    got = tf.unpack_frames(zo, p, ff, cc, obias, dst)
                    want = tf.unpack_frames_ref(zo, p, ff, cc, obias, dst)
                    if dst is bf:
                        check_conv("unpack_frames", f"{what} z {off} "
                                   f"elements off 16 bytes", got, want)
                    else:
                        check_close("unpack_frames", f"{what} z {off} "
                                    f"elements off 16 bytes", got, want,
                                    1e-6 / max(float(want.abs().max()),
                                               1e-30))
            layout("unpack_frames", what, make,
                   lambda z, p=p, ff=ff, cc=cc, obias=obias, dst=dst:
                       tf.unpack_frames(z, p, ff, cc, obias, dst),
                   lambda z, p=p, ff=ff, cc=cc, obias=obias, dst=dst:
                       tf.unpack_frames_ref(z, p, ff, cc, obias, dst),
                   seeded((b, cc, p.h, p.w), bf),
                   lambda x, ff=ff: F.pixel_shuffle(x, ff),
                   "pixel_shuffle of a dense bf16 NCHW input: no border "
                   "slice, no out_img, bf16 NCHW out",
                   2 * cc * b * p.h * p.w + out.numel() * out.element_size(),
                   4 * cc * b * p.h * p.w, key)
    return records


def _bf16_step(torch, tf, cfg, sd, frames_dir, arch, timed):
    """One phase-2 calibration step of `arch` at Bunny-3M, batch 2, fq_impl
    pallas, with the decode in fp32 and in bf16 (``make_loss(...,
    compute_dtype=bfloat16)``) on the same state: the bf16 step's loss
    within BF16_TOL and its gradients within BF16_TOL of each leaf's
    largest (BF16_FLOOR) of the fp32 step's; its launches, the fp32
    step's on the bf16 instantiations. With `timed`: both steps in turns,
    fp32 / bf16 / bf16 / fp32, 10 steps each, ms a step."""
    from neuroquant_tpu_torch.data import VideoDataSet
    from neuroquant_tpu_torch.models import build_model, tail_plan_for
    from neuroquant_tpu_torch.quantization import (
        adaround_upgrade, init_quant_state, make_spec)
    from neuroquant_tpu_torch.quantization.calibrate import make_loss
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    dev = torch.device("cuda")
    model = build_model(arch, cfg, device=dev)
    model.load_state_dict(state_dict_from_numpy(sd, dev), strict=True)
    model.eval()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    spec = make_spec(arch, cfg, channel_wise=True, scale_method="max",
                     hadamard=True, fq_impl="pallas").with_bits(
                         _precision(arch, cfg))
    state = adaround_upgrade(params, spec, init_quant_state(params, spec))
    data = VideoDataSet(cfg, frames_dir, device=dev)
    with torch.no_grad():
        emb = model.encode(model.model_input(data.frames, data.norm_idx)
                           [:CALIB_BATCH])
    plan, f, ch = tail_plan_for(arch, cfg)
    pack = {"gt": tf.pack_targets(data.frames[:CALIB_BATCH], plan, f),
            "mask": tf.border_mask(plan, ch=ch, device=dev),
            "denom": cfg["crop_h"] * cfg["crop_w"]}
    losses = {dt: make_loss(model, params, spec, "adaround", 2.0, pack,
                            compute_dtype=dt)
              for dt in (None, torch.bfloat16)}

    def step(dt):
        st = {ln: {k: v.clone().requires_grad_(k.endswith("alpha"))
                   for k, v in s.items()} for ln, s in state.items()}
        total = losses[dt](st, pack["gt"], emb, 1)[0]
        total.backward()
        return total, {(ln, k): st[ln][k].grad for ln in st
                       for k in st[ln] if k.endswith("alpha")}

    l32, g32 = step(None)
    tf.reset_launch_counts()
    l16, g16 = step(torch.bfloat16)
    torch.cuda.synchronize()
    counts = dict(tf.KERNEL_LAUNCHES)
    l32, l16 = float(l32.detach()), float(l16.detach())
    top = max(float(g.abs().max()) for g in g32.values())
    worst, worst_leaf = 0.0, None
    for key, g in g32.items():
        assert g16[key].dtype == torch.float32, key
        scale = max(float(g.abs().max()), BF16_FLOOR * top)
        e = float((g16[key] - g).abs().max()) / scale
        if e > worst:
            worst, worst_leaf = e, key
    rel = abs(l16 - l32) / abs(l32)
    want = _bf16(_fq_phases(arch, cfg)[1])
    print(f"  {arch} one phase-2 step in bf16 against fp32 (batch "
          f"{CALIB_BATCH}, fq_impl pallas): loss {l16:.7f} vs {l32:.7f} "
          f"(rel {rel:.2e}, tol {BF16_TOL:.2e}); gradients, worst leaf "
          f"{worst:.2e} of its largest (floor {BF16_FLOOR:.0e} of the "
          f"step's) at {worst_leaf} (tol {BF16_TOL:.2e}); launches {counts}")
    assert counts == want, (counts, want)
    assert rel <= BF16_TOL and worst <= BF16_TOL, (rel, worst)
    out = dict(loss_rel=rel, grad_rel=worst, launches=counts)
    if not timed:
        return out
    ms = {None: [], torch.bfloat16: []}
    for dt in (None, torch.bfloat16, torch.bfloat16, None):
        step(dt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step(dt)
        torch.cuda.synchronize()
        ms[dt].append(1e3 * (time.perf_counter() - t0) / 10)
    print(f"  {arch} calibration step (batch {CALIB_BATCH}, fq_impl pallas, "
          f"10 a turn, turns fp32 / bf16 / bf16 / fp32): fp32 "
          f"{ms[None][0]:.2f} / {ms[None][1]:.2f} ms, bf16 "
          f"{ms[torch.bfloat16][0]:.2f} / {ms[torch.bfloat16][1]:.2f} ms")
    prof = {dt: _profile_steps(torch, lambda dt=dt: step(dt), n=5,
                               what="step")
            for dt in (None, torch.bfloat16)}
    return dict(out, fp32_ms=ms[None], bf16_ms=ms[torch.bfloat16],
                fp32_profile=prof[None], bf16_profile=prof[torch.bfloat16])


def _bf16_stage1_turns(torch, cfg, sd, frames_dir):
    """A stage-1 step of HNeRV Bunny-3M at batch 1 as regress's loop runs
    it (forward, loss, backward, Adam; no synchronize), 20 back to back in
    turns: default / bfloat16 / bfloat16 / default matmul precision; then
    a profiler window of each: ms a step, busy and idle share. The same
    for a decode at batch 1 (the embedding given; CUDA events)."""
    from neuroquant_tpu_torch.data import VideoDataSet
    from neuroquant_tpu_torch.metrics import loss_fn
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.ops import precision
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    dev = torch.device("cuda")
    model = build_model("hnerv", cfg, device=dev)
    model.load_state_dict(state_dict_from_numpy(sd, dev), strict=True)
    data = VideoDataSet(cfg, frames_dir, device=dev)
    img = data.frames[:1].clone()
    opt = torch.optim.Adam(model.parameters(), lr=cfg["learning_rate"],
                           eps=1e-8)

    def loop_step():
        opt.zero_grad(set_to_none=True)
        loss_fn(model(img), img, cfg["loss"]).backward()
        opt.step()

    with torch.no_grad():
        emb = model.encode(img)
    dec_ms = {"default": [], "bfloat16": []}
    for mode in ("default", "bfloat16", "bfloat16", "default"):
        with precision.matmul_precision(mode), torch.no_grad():
            dec_ms[mode].append(_time_ms(lambda: model.decode(emb), iters=20))
    with precision.matmul_precision("bfloat16"), torch.no_grad():
        dec_prof = _profile_steps(torch, lambda: model.decode(emb), n=20,
                                  what="decode")
    print(f"  decode (batch 1, 20 a turn, turns default / bfloat16 / "
          f"bfloat16 / default): default {dec_ms['default'][0]:.3f} / "
          f"{dec_ms['default'][1]:.3f} ms, bfloat16 "
          f"{dec_ms['bfloat16'][0]:.3f} / {dec_ms['bfloat16'][1]:.3f} ms")
    ms = {"default": [], "bfloat16": []}
    for mode in ("default", "bfloat16", "bfloat16", "default"):
        with precision.matmul_precision(mode):
            for _ in range(3):
                loop_step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                loop_step()
            torch.cuda.synchronize()
            ms[mode].append(1e3 * (time.perf_counter() - t0) / 20)
    prof = {}
    for mode in ("default", "bfloat16"):
        with precision.matmul_precision(mode):
            prof[mode] = _profile_steps(torch, loop_step, what="step")
    print(f"  stage-1 step (batch 1, 20 a turn, turns default / bfloat16 / "
          f"bfloat16 / default): default {ms['default'][0]:.3f} / "
          f"{ms['default'][1]:.3f} ms, bfloat16 {ms['bfloat16'][0]:.3f} / "
          f"{ms['bfloat16'][1]:.3f} ms")
    return dict(ms=ms, profile=prof, decode_ms=dec_ms,
                bf16_decode_profile=dec_prof)


def _bf16_dp(torch, tf, sd, frames_dir, card, work):
    """Both bf16 flags through the rank function ``--mesh_devices`` runs,
    at world size 1 over NCCL, against one process (phase 16 (a)'s
    arrangement): DP_STEPS bf16 calibration steps (fq_impl pallas) and
    DP_STEPS bf16 stage-1 steps at batch 2, bitwise equal, every step on
    the bf16 instantiations."""
    import yaml

    from neuroquant_tpu_torch.config import get_config
    from neuroquant_tpu_torch.parallel.mesh import _free_port, run_rank

    pth = os.path.join(work, "hnerv_seeded.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    stage1_cfg = os.path.join(work, "hnerv_dp_stage1.yaml")
    with open(stage1_cfg, "w") as f:
        yaml.safe_dump(dict(get_config(os.path.join(REPO, HNERV_CONFIG)),
                            epoch=DP_STEPS * CALIB_BATCH // N_FRAMES,
                            batch_size=CALIB_BATCH), f)
    args = (work, frames_dir, pth, stage1_cfg, "pallas", True, "hnerv",
            ("--compute_dtype", "bfloat16"),
            ("--matmul_precision", "bfloat16"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        one = _dp_steps(None, *args)
        ws1 = run_rank(0, 1, "cuda:0", "nccl",
                       f"tcp://127.0.0.1:{_free_port()}", _dp_steps, args)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = _state_leaves(one["state"]), _state_leaves(ws1["state"])
    same_state = all(torch.equal(a[k], b[k]) for k in a)
    same_weights = all(torch.equal(ws1["weights"][k], w)
                       for k, w in one["weights"].items())
    print(f"  bf16 through --mesh_devices' rank function, world size 1 over "
          f"NCCL, against one process: calibrate_network --compute_dtype "
          f"bfloat16 --fq_impl pallas, {DP_STEPS} steps: state "
          f"{'bitwise equal' if same_state else 'DIFFERENT'}; regress "
          f"--matmul_precision bfloat16, {DP_STEPS} steps: weights "
          f"{'bitwise equal' if same_weights else 'DIFFERENT'}; launches "
          f"{ws1['launches']}; card {card}")
    assert same_state and one["calib_losses"] == ws1["calib_losses"]
    assert same_weights and one["stage1_losses"] == ws1["stage1_losses"]
    for k in BF16_KERNELS:
        assert ws1["launches"][k + "_bf16"] > 0 or k == "unpack_frames", (
            k, ws1["launches"])
    return dict(launches=ws1["launches"], calib_losses=ws1["calib_losses"],
                stage1_losses=ws1["stage1_losses"])


def _bf16_families(torch, tf, frames_dir, card, work):
    """Both bf16 flags for NeRV, PNeRV1 and PNeRV2 Bunny-3M (seeded
    weights for the calibration, torch's init for stage 1):
    ``calibrate_network --compute_dtype bfloat16 --fq_impl pallas`` and
    ``regress --matmul_precision bfloat16`` as phases 7 and 12 run them,
    every step's launches on the bf16 instantiations."""
    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.models import build_model

    out = {}
    for i, arch in enumerate(("nerv", "pnerv", "pnerv2")):
        acfg = validate_config(get_config(os.path.join(REPO, _CONFIGS[arch])),
                               arch)
        acfg["workers"] = 0
        if arch == "nerv":
            acfg["n_frames"] = N_FRAMES
        m = build_model(arch, acfg, device="cuda")
        asd = _seeded_state_dict(m, np.random.RandomState(SEED + 190 + i))
        del m
        out[arch] = dict(
            calibrate=_calibrate_phase(torch, tf, acfg, asd, frames_dir,
                                       card, work, "pallas", arch=arch,
                                       bf16=True),
            stage1=_stage1_run_phase(torch, tf, frames_dir, card, work,
                                     arch=arch, bf16=True))
    return out


def _bf16_phase(torch, tf, cfg, sd, frames_dir, card, work, calib_fq):
    """Phase 19: the bf16 instantiations at HNeRV Bunny-3M against their
    plain versions (:func:`_bf16_kernel_phase`); ``calibrate_network
    --compute_dtype bfloat16 --fq_impl pallas`` (phase 9's settings) with
    every step's launches on the bf16 instantiations, its PSNR blocks
    against phase 9's, then ``compress`` and ``eval_quantized
    --from_bitstream``; one bf16 calibration step of HNeRV, NeRV and
    PNeRV1 against their fp32 step, HNeRV's timed in turns with it;
    ``regress --matmul_precision bfloat16`` for phase 12's 3 epochs, and
    a stage-1 step timed in turns with the default precision; both flags
    through ``--mesh_devices``' rank function at world size 1; both CLIs
    for NeRV, PNeRV1 and PNeRV2."""
    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    _section("phase 19, bf16: kernels")
    model = build_model("hnerv", cfg, device="cuda")
    model.load_state_dict(state_dict_from_numpy(sd, "cuda"), strict=True)
    kern = _bf16_kernel_phase(torch, tf, cfg, model)
    del model
    _section("phase 19, bf16: calibrate_network --compute_dtype bfloat16")
    calib = _calibrate_phase(torch, tf, cfg, sd, frames_dir, card, work,
                             "pallas", bf16=True)
    gain = abs(calib_fq["psnr_blocks"][3] - calib_fq["psnr_blocks"][2])
    tol = [PSNR_TOL] * 3 + [BF16_PSNR_TOL + 0.1 * gain]
    gaps = [abs(a - b) for a, b in zip(calib["psnr_blocks"],
                                       calib_fq["psnr_blocks"])]
    print(f"  PSNR blocks, bf16 vs phase 9's fp32 (fq_impl pallas): "
          f"{calib['psnr_blocks']} vs {calib_fq['psnr_blocks']}; gaps "
          f"{[round(x, 4) for x in gaps]} dB (tol "
          f"{[round(x, 4) for x in tol]}); phase 2 it/s bf16 "
          f"{calib['phase2_its']}, fp32 {calib_fq['phase2_its']} (phase 9's "
          f"run); card {card}")
    assert all(g <= t for g, t in zip(gaps, tol)), (gaps, tol)
    stream = _bitstream_phase(torch, tf, calib, frames_dir, card)
    _section("phase 19, bf16: calibration steps")
    steps = {"hnerv": _bf16_step(torch, tf, cfg, sd, frames_dir, "hnerv",
                                 timed=True)}
    for arch in ("nerv", "pnerv"):
        acfg = validate_config(get_config(os.path.join(REPO, _CONFIGS[arch])),
                               arch)
        acfg["workers"] = 0
        if arch == "nerv":
            acfg["n_frames"] = N_FRAMES
        m = build_model(arch, acfg, device="cuda")
        asd = _seeded_state_dict(m, np.random.RandomState(SEED + 19))
        del m
        steps[arch] = _bf16_step(torch, tf, acfg, asd, frames_dir, arch,
                                 timed=False)
    _section("phase 19, bf16: regress --matmul_precision bfloat16")
    s1 = _stage1_run_phase(torch, tf, frames_dir, card, work, bf16=True)
    turns = _bf16_stage1_turns(torch, cfg, sd, frames_dir)
    _section("phase 19, bf16: --mesh_devices, world size 1")
    dp = _bf16_dp(torch, tf, sd, frames_dir, card, work)
    _section("phase 19, bf16: NeRV, PNeRV1, PNeRV2")
    families = _bf16_families(torch, tf, frames_dir, card, work)
    return dict(kernels=kern, calibrate=calib, stream=stream, steps=steps,
                stage1=s1, stage1_turns=turns, data_parallel=dp,
                families=families)


def _norm_acts_phase(torch, tf, card, frames_dir, work):
    """Phase 20: the last two flags at full width, HNeRV Bunny-3M with
    ``dec_norm: batch, dec_acts: swish`` and NeRV Bunny-3M with ``dec_norm:
    instance, dec_acts: relu`` (the configs' other keys, seeded weights,
    the 8 seeded frames). Such a decoder never packs its tail, so it runs
    the plain unpacked chain on cuDNN: a decode at batch 2 launches none of
    the port's kernels (``KERNEL_LAUNCHES``) and matches a float64 run of
    the same module on the card (DECODE_TOL); one stage-1 step at batch 2
    (its loss within LOSS_TOL, every leaf's gradient against float64); one
    stage-2 HVP batch on both routes (``fused_tail: off`` and
    ``pallas_hvp``, each launching no kernel) against float64. Every leaf
    is on cuDNN's fp32 convs, so it is held to CUDNN64_TOL of its largest
    (cuDNN's fp32 against float64 at these shapes; the worst printed beside
    GRAD_TOL and HV64_TOL), the two HVP routes to GRAD_TOL of each other.
    Then ``calibrate_network.main`` (8 steps), ``compress`` and
    ``eval_quantized`` from the artifact and ``--from_bitstream``, whose
    PSNRs agree within STREAM_PSNR_TOL."""
    import yaml

    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.data import VideoDataSet
    from neuroquant_tpu_torch.methods import (
        calibrate_network, compress, eval_quantized)
    from neuroquant_tpu_torch.metrics import loss_fn
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.quantization import (
        get_perturbation, init_quant_state, make_spec)
    from neuroquant_tpu_torch.quantization import sensitivity as sens
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    dev = torch.device("cuda")
    t_phase = time.time()
    out = {}

    def leaf_errs(got, want):
        return [float((a.double() - b.double()).abs().max())
                / max(float(b.abs().max()), 1e-30) for a, b in zip(got, want)]

    for arch, norm, act, seed in (("hnerv", "batch", "swish", SEED + 20),
                                  ("nerv", "instance", "relu", SEED + 21)):
        tag = f"{arch} dec_norm={norm} dec_acts={act}"
        _section(f"phase 20: {tag}")
        with open(os.path.join(REPO, _CONFIGS[arch])) as f:
            raw = yaml.safe_load(f)
        raw.update(dec_norm=norm, dec_acts=act)
        cfg_path = os.path.join(work, f"{arch}_{norm}_{act}.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(raw, f)
        cfg = validate_config(get_config(cfg_path), arch)
        cfg["workers"] = 0
        if arch == "nerv":
            cfg["n_frames"] = N_FRAMES
        data = VideoDataSet(cfg, frames_dir, device=dev)

        def model_for(ft, dtype=torch.float32):
            m = build_model(arch, dict(cfg, fused_tail=ft), device=dev)
            m.load_state_dict(params, strict=True)
            return m.to(dtype)

        model = build_model(arch, cfg, device=dev)
        sd = _seeded_state_dict(model, np.random.RandomState(seed))
        params = state_dict_from_numpy(sd, dev)
        model.load_state_dict(params, strict=True)
        assert model.pack_start is None and model._fused_impl() is None
        m64 = model_for("auto", torch.float64)
        inp = model.model_input(data.frames, data.norm_idx)[:CALIB_BATCH]
        img = data.frames[:CALIB_BATCH]
        rec = {}

        # the decode at batch 2: no port kernel, float64's frames
        with torch.no_grad():
            emb = model.encode(inp)
            torch.cuda.synchronize()
            tf.reset_launch_counts()
            y = model.decode(emb)
            torch.cuda.synchronize()
            counts = dict(tf.KERNEL_LAUNCHES)
            rec["decode_ms"] = _time_ms(lambda: model.decode(emb), iters=10)
            y64 = m64.decode(m64.encode(inp.double()))
        rec["decode_err64"] = float((y.double() - y64).abs().max())
        print(f"  decode, batch {CALIB_BATCH}: {rec['decode_ms']:.3f} ms "
              f"back to back; max|frames - float64| "
              f"{rec['decode_err64']:.2e} (tol {DECODE_TOL:.0e}); the "
              f"port's kernel launches {sum(counts.values())}; card {card}")
        assert not any(counts.values()), counts
        assert rec["decode_err64"] <= DECODE_TOL, rec["decode_err64"]

        # one stage-1 step at batch 2 against float64
        def step(m, dtype):
            m.zero_grad(set_to_none=True)
            loss = loss_fn(m(inp.to(dtype)), img.to(dtype), cfg["loss"])
            loss.backward()
            torch.cuda.synchronize()
            return float(loss.detach()), [p.grad for _, p in
                                          m.named_parameters()]

        tf.reset_launch_counts()
        t0 = time.time()
        loss32, g32 = step(model, torch.float32)
        rec["step_s"] = time.time() - t0
        assert not any(tf.KERNEL_LAUNCHES.values()), tf.KERNEL_LAUNCHES
        loss64, g64 = step(m64, torch.float64)
        names = [n for n, _ in model.named_parameters()]
        errs = leaf_errs(g32, g64)
        worst = int(np.argmax(errs))
        rec.update(loss=loss32, loss64=loss64, step_grad_err64=errs[worst],
                   step_grad_leaf=names[worst])
        rel = abs(loss32 - loss64) / abs(loss64)
        print(f"  one stage-1 step, batch {CALIB_BATCH}: loss {loss32:.8f} "
              f"vs {loss64:.8f} float64 (rel {rel:.2e}, tol "
              f"{LOSS_TOL:.0e}); worst leaf max|diff| / max|grad| "
              f"{errs[worst]:.2e} ({names[worst]}; GRAD_TOL {GRAD_TOL:.0e}, "
              f"held to {CUDNN64_TOL:.0e}); {rec['step_s']:.3f} s, the "
              f"first of its shapes")
        assert rel <= LOSS_TOL, (loss32, loss64)
        assert errs[worst] <= CUDNN64_TOL, (names[worst], errs[worst])
        del g32, g64

        # one stage-2 HVP batch on both routes against float64
        spec = make_spec(arch, cfg, channel_wise=True, scale_method="max"
                         ).with_bits(_precision(arch, cfg))
        vec = get_perturbation(params, spec, init_quant_state(params, spec))
        batch = sens.draw_batches(N_FRAMES, CALIB_BATCH, 903)[:1]
        hv = {}
        for route, ft in (("xla", "off"), ("pallas", "pallas_hvp")):
            mr = model_for(ft)
            tf.reset_launch_counts()
            t0 = time.time()
            hv[route] = sens.hessian_vector_product(
                mr, spec, vec, data.frames, data.norm_idx, batch)
            torch.cuda.synchronize()
            rec[f"hvp_{route}_s"] = time.time() - t0
            assert not any(tf.KERNEL_LAUNCHES.values()), tf.KERNEL_LAUNCHES
            del mr
        hv64 = sens.hessian_vector_product(
            m64, spec, [v.double() for v in vec], data.frames.double(),
            data.norm_idx, batch)
        e64 = {r: leaf_errs(hv[r], hv64) for r in hv}
        eroute = leaf_errs(hv["pallas"], hv["xla"])
        rec.update(hvp_err64=max(max(e) for e in e64.values()),
                   hvp_route_err=max(eroute))
        print(f"  one HVP batch: leaf max|diff| / max|Hv| against float64, "
              f"--hvp_impl xla {' '.join(f'{e:.2e}' for e in e64['xla'])}, "
              f"pallas {' '.join(f'{e:.2e}' for e in e64['pallas'])} "
              f"(HV64_TOL {HV64_TOL:.0e}, held to {CUDNN64_TOL:.0e}); the "
              f"routes apart {rec['hvp_route_err']:.2e} (tol "
              f"{GRAD_TOL:.0e}); {rec['hvp_xla_s']:.3f} / "
              f"{rec['hvp_pallas_s']:.3f} s")
        assert rec["hvp_err64"] <= CUDNN64_TOL, e64
        assert rec["hvp_route_err"] <= GRAD_TOL, eroute
        del hv, hv64, vec, m64, model

        # calibrate_network, compress, eval_quantized --from_bitstream
        pth = os.path.join(work, f"{arch}_{norm}_seeded.pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
        cwd = os.getcwd()
        try:
            os.chdir(work)
            t0 = time.time()
            art, _, _ = calibrate_network.main([
                "--config", cfg_path, "--arch", arch, "--data_path",
                frames_dir, "--vid", "Bunny", "--outf", f"{arch}_{norm}",
                "--ckpt", pth, "--precision",
                *map(str, _precision(arch, cfg)), "--hadamard",
                "--channel_wise", "--batch_size", str(CALIB_BATCH),
                "--iters_w", "8", "--lr", "0.003"])
            rec["calibrate_s"] = time.time() - t0
            art = os.path.join(work, art)
            report = compress.main(["--artifact", art, "--data_path",
                                    frames_dir])
            state = eval_quantized.main(["--artifact", art, "--data_path",
                                         frames_dir])
            stream = eval_quantized.main([
                "--artifact", art, "--data_path", frames_dir,
                "--from_bitstream", report["bitstream"]])
        finally:
            os.chdir(cwd)
        rec.update(psnr=float(np.mean(state[0])),
                   stream_psnr=float(np.mean(stream[0])),
                   bpp=report.get("bpp"))
        print(f"  calibrate_network (8 steps) {rec['calibrate_s']:.1f} s; "
              f"eval_quantized PSNR {rec['psnr']:.4f} dB, from the stream "
              f"{rec['stream_psnr']:.4f} (tol {STREAM_PSNR_TOL}); card "
              f"{card}")
        assert np.isfinite(rec["psnr"]) and rec["psnr"] > 5.0, rec
        assert abs(rec["psnr"] - rec["stream_psnr"]) <= STREAM_PSNR_TOL, rec
        out[f"{arch}_{norm}_{act}"] = rec
    _section()
    out["seconds"] = time.time() - t_phase
    print(f"  phase 20: {out['seconds']:.1f} s; card {card}")
    return out


def _write_frames(path: str, rng):
    from PIL import Image

    yy, xx = np.mgrid[0:720, 0:1280].astype(np.float32)
    for t in range(N_FRAMES):
        img = np.stack([xx / 1280, yy / 720,
                        np.full_like(xx, 0.5 + 0.4 * math.sin(t))], -1)
        img = np.clip(img + 0.05 * rng.randn(720, 1280, 3), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(path, f"{t + 1:04d}.png"))


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _serving_phase(torch, tf, cfg, sd, card, frames):
    from neuroquant_tpu_torch.methods import eval_quantized
    from neuroquant_tpu_torch.quantization.qmodel import init_quant_state
    from neuroquant_tpu_torch.quantization.spec import make_spec
    from neuroquant_tpu_torch.utils.convert import (
        quant_state_to_numpy, state_dict_from_numpy)

    spec = make_spec("hnerv", cfg, channel_wise=True, scale_method="max",
                     hadamard=True).with_bits(PRECISION)
    state = init_quant_state(state_dict_from_numpy(sd, "cuda"), spec)
    artifact = {
        "arch": "hnerv", "mode": "uaq", "cfg": cfg, "state_dict": sd,
        "quant_spec": {
            "layer_names": spec.layer_names, "layer_paths": spec.layer_paths,
            "n_bits": spec.n_bits, "channel_wise": spec.channel_wise,
            "scale_method": spec.scale_method, "hadamard": spec.hadamard,
            "sym": spec.sym},
        "quant_state": quant_state_to_numpy(state),
    }
    tmp = tempfile.mkdtemp(prefix="nq_chip_smoke_")
    try:
        art = os.path.join(tmp, "artifact.pth")
        with open(art, "wb") as f:
            pickle.dump(artifact, f)
        # the stdout handler eval_quantized would install, installed first,
        # so that its INFO lines both print and reach the capture
        logging.basicConfig(stream=sys.stdout, level=logging.INFO)
        cap = _Capture()
        logging.getLogger().addHandler(cap)
        tf.reset_launch_counts()
        t0 = time.time()
        results = eval_quantized.main(["--artifact", art, "--data_path",
                                       frames, "--eval_fps"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(tf.KERNEL_LAUNCHES)
        logging.getLogger().removeHandler(cap)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    psnr, msssim = float(results[0]), float(results[1])
    assert math.isfinite(psnr) and math.isfinite(msssim), results
    assert 0.0 < msssim <= 1.0, msssim
    fps_lines = [m for m in cap.lines if "decode throughput" in m]
    fps = float(re.search(r"throughput: ([0-9.]+) FPS", fps_lines[-1])[1])
    print(f"  eval_quantized on {N_FRAMES} frames: PSNR {psnr:.4f} dB, "
          f"MS-SSIM {msssim:.6f}, {wall:.2f} s wall; launches {launches}")
    print(f"  decode FPS (batch 1, eval_quantized --eval_fps): {fps} on "
          f"{card}")
    return dict(psnr=psnr, msssim=msssim, fps=fps, launches=launches)


def _add_model_records(kernels, nerv, key="nerv"):
    """Add phase 13's (NeRV's) or phase 14's (PNeRV1's, `key` 'pnerv')
    records to each entry of the kernels line: per launch
    ("<key>_per_launch"), the model's decode shapes (batch 1), a training
    step's at batch 1 and 2, its fake-quant layers; its launches per
    decode, calibration step, stage-1 step and HVP batch, and over its
    stage-1 and calibrate_network runs (fq_impl pallas for the fake-quant
    entries); its largest error against the plain versions. Every kernel
    must have run in its calibrate_network --fq_impl pallas run."""
    nk, b1, b2 = nerv["kernels"], nerv["kernels_b1"], nerv["kernels_b2"]
    per = {
        "tail_conv_cf": nk["tail_conv_cf"]["per_launch"]
        + b1["tail_conv_cf"]["per_launch"] + b2["tail_conv_cf"]["per_launch"],
        "tail_conv_dw_cf": b1["tail_conv_dw_cf"]["per_launch"]
        + b2["tail_conv_dw_cf"]["per_launch"],
        "pack_cf": nk["pack_cf"]["per_launch"]
        + nk["pack_cf"]["calibration_per_launch"],
        "unpack_cf": b1["unpack_cf"]["per_launch"]
        + b2["unpack_cf"]["per_launch"],
        "unpack_frames": nk["unpack_frames"]["per_launch"]}
    for k in kernels:
        name = k["name"]
        fq = name.startswith("fq_")
        k[f"{key}_per_launch"] = nerv["fq"][name]["per_launch"] if fq else \
            per[name]
        k[f"{key}_max_abs_err"] = max(
            r.get(name, {"max_abs_err": 0.0})["max_abs_err"]
            for r in (nk, b1, b2, nerv["fq"]))
        run = nerv["calibrate_pallas" if fq else "calibrate_jnp"]
        k[f"{key}_launches"] = {
            "calibrate_run": run["launches"][name],
            "per_decode": nerv["decode"]["launches"][name] // 4,
            "per_calibration_step": nerv["step"]["launches"][name],
            "per_stage1_step": nerv["stage1_step"]["launches"][name],
            "stage1_run": nerv["stage1"]["launches"][name],
            "stage2_hvp_batch": nerv["stage2"]["runs"]["omega pallas"][
                "launches_per_batch"][name]}
        if "pnerv2_decode" in nerv:
            k["pnerv2_launches"] = {
                "calibrate_run": nerv["pnerv2_calibrate"]["launches"][name],
                "per_decode": nerv["pnerv2_decode"]["launches"][name] // 4,
                "per_calibration_step": nerv["pnerv2_step"]["launches"][
                    name]}
        assert nerv["calibrate_pallas"]["launches"][name] > 0, name


def main() -> int:
    import torch

    # the package first: a copy of this script without the repository
    # fails here, with or without a card
    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.ops import _cuda
    from neuroquant_tpu_torch.ops import tail_fused as tf
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy
    from neuroquant_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    resolve_device("cuda")          # the port's entry points turn TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    assert tf32 == (False, False), tf32
    card = _card_line()
    print(card)
    print(f"card: {card} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | TF32 off "
          f"(cudnn.allow_tf32={tf32[0]}, cuda.matmul.allow_tf32={tf32[1]}, "
          f"set by resolve_device)")
    t_start = time.time()

    print("[build]")
    t0 = time.time()
    _cuda.build()
    _cuda.lib()
    print(f"  kernels built/loaded in {time.time() - t0:.2f} s "
          f"(nvcc wall {_cuda.BUILD_INFO['seconds']})")
    for line in _cuda.BUILD_INFO["log"].splitlines():
        # per kernel: registers, static shared memory, spills (ptxas -v)
        if line.startswith("==") or "registers" in line or "spill" in line:
            print("   ", line.strip())
        elif "Compiling entry function" in line and "tail_conv" in line:
            print("   ", line.strip()[:160])

    cfg = validate_config(get_config(os.path.join(REPO, HNERV_CONFIG)),
                          "hnerv")
    cfg["workers"] = 0
    rng = np.random.RandomState(SEED)
    model = build_model("hnerv", cfg, device="cuda")
    sd = _seeded_state_dict(model, rng)
    model.load_state_dict(state_dict_from_numpy(sd, "cuda"), strict=True)
    model.eval()

    frames_dir = tempfile.mkdtemp(prefix="nq_chip_frames_")
    work = tempfile.mkdtemp(prefix="nq_chip_calib_")
    try:
        _write_frames(frames_dir, rng)
        print("[kernels]")
        records = _kernel_phase(torch, tf, cfg, model)
        print("[kernels: calibration step, batch 2]")
        brecords = _backward_kernel_phase(torch, tf, cfg, model)
        print("[decode]")
        dec = _decode_phase(torch, tf, cfg, sd, model)
        print("[serving]")
        serve = _serving_phase(torch, tf, cfg, sd, card, frames_dir)
        print("[calibration step: gradients, launches, time]")
        grad = _gradient_phase(torch, tf, cfg, sd, frames_dir)
        print("[calibrate]")
        calib = _calibrate_phase(torch, tf, cfg, sd, frames_dir, card, work,
                                 "jnp")
        print("[kernels: fake-quant]")
        frecords = _fq_kernel_phase(torch, tf, cfg, sd)
        print("[calibrate, --fq_impl pallas]")
        calib_fq = _calibrate_phase(torch, tf, cfg, sd, frames_dir, card,
                                    work, "pallas")
        worst = max(abs(a - b) for a, b in zip(calib_fq["psnr_blocks"],
                                               calib["psnr_blocks"]))
        print(f"  PSNR blocks, fq_impl pallas vs jnp at --iters_w "
              f"{CALIB_ITERS}: {calib_fq['psnr_blocks']} vs "
              f"{calib['psnr_blocks']} (max diff {worst:.3f} dB, tol "
              f"{PSNR_TOL}); phase 2 it/s: pallas {calib_fq['phase2_its']}, "
              f"jnp {calib['phase2_its']}; card {card}")
        assert worst <= PSNR_TOL, (calib_fq["psnr_blocks"],
                                   calib["psnr_blocks"])
        print("[bitstream]")
        stream = _bitstream_phase(torch, tf, calib_fq, frames_dir, card)
        print("[stage 2: bit_assign]")
        stage2 = _stage2_phase(torch, tf, cfg, sd, frames_dir, card, work)
        print("[kernels: stage-1 step, batch 1]")
        s1records = _backward_kernel_phase(torch, tf, cfg, model, batch=1)
        s1unpack = _unpack_frames_backward(torch, tf, cfg, model)
        print("[stage-1 step: gradients, launches, time]")
        s1step = _stage1_step_phase(torch, tf, cfg, sd, frames_dir)
        print("[stage 1: regress]")
        s1run = _stage1_run_phase(torch, tf, frames_dir, card, work)
        del model
        # phase 19 runs here, beside the phases of the same model: after
        # phase 16's ranks and phase 18's process the profiler's traces
        # drop device events now and then
        t19 = time.time()
        bf = _bf16_phase(torch, tf, cfg, sd, frames_dir, card, work,
                         calib_fq)
        _section()
        bf["seconds"] = time.time() - t19
        nerv = _nerv_phase(torch, tf, card, frames_dir, work)
        pnerv = _pnerv_phase(torch, tf, card, frames_dir, work)
        unit = _unit_scope_phase(torch, tf, cfg, sd, frames_dir, card, work)
        print("[data parallel]")
        dp = _dp_phase(torch, tf, sd, frames_dir, card, work)
        print("[loss landscape]")
        land = _landscape_phase(torch, tf, cfg, sd, frames_dir, card)
        print("[bench]")
        bench = _bench_phase(card)
        norm_acts = _norm_acts_phase(torch, tf, card, frames_dir, work)
    finally:
        shutil.rmtree(frames_dir, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)

    src = "neuroquant_tpu_torch/csrc/{}.cu".format
    tpu = "neuroquant_tpu/ops/tail_fused.py:{}".format
    fq = "neuroquant_tpu/ops/pallas_fakequant.py:{}".format
    # the decode's kernels are summed over one decode's launches (batch 1),
    # the calibration's kernels over one step's (batch 2), the fake-quant
    # entries over one quantize_params call's seven layers; "launches" is
    # the count over a calibrate_network run (its steps and its evals): the
    # fq_impl jnp run for the tail's kernels, the fq_impl pallas run, which
    # the bitstream is made from, for the fake-quant entries
    sources = [("tail_conv_cf", records, tpu(1133), "per decode", calib),
               ("tail_conv_dw_cf", brecords, tpu(1172), "per step", calib),
               ("pack_cf", records, tpu(656), "per decode", calib),
               ("unpack_cf", brecords, tpu(666), "per step", calib),
               ("unpack_frames", records, tpu(2016), "per decode", calib),
               ("fq_uaq", frecords, fq(69), "per quantize_params call",
                calib_fq),
               ("fq_ada", frecords, fq(83), "per quantize_params call",
                calib_fq),
               # the JAX package's backward is the VJP of its plain chain
               # (no Pallas kernel); here it is a kernel of its own
               ("fq_uaq_bwd", frecords, fq(213) + " _uaq_bwd (jnp VJP)",
                "per quantize_params backward", calib_fq),
               ("fq_ada_bwd", frecords, fq(238) + " _ada_bwd (jnp VJP)",
                "per quantize_params backward", calib_fq)]
    kernels = []
    for name, recs, replaces, summed, run in sources:
        per = recs[name]["per_launch"]
        t_ops = sum(p["bound_ms"] for p in per if p["bound_by"] == "operations")
        t_bytes = sum(p["bound_ms"] for p in per if p["bound_by"] == "bytes")
        err = max(recs[name]["max_abs_err"],
                  brecords.get(name, {"max_abs_err": 0.0})["max_abs_err"],
                  s1records.get(name, {"max_abs_err": 0.0})["max_abs_err"])
        is_fq = name.startswith("fq_")
        kernels.append({
            "name": name, "route": "cuda",
            "source": src("fq_hadamard" if is_fq else name),
            "replaces": replaces, "launches": run["launches"][name],
            "fq_pallas_run_launches": calib_fq["launches"][name],
            "max_abs_err": err,
            "ms": sum(p["ms"] for p in per),
            "plain_ms": sum(p["plain_ms"] for p in per),
            "bound_ms": sum(p["bound_ms"] for p in per),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            # no single PyTorch call computes the fused fake-quant chain
            "library_ms": (None if is_fq
                           else sum(p["library_ms"] for p in per)),
            "summed": summed,
            **({"bound_tc_ms": sum(p["bound_tc_ms"] for p in per)}
               if name.startswith("tail_conv") else {}),
            **({"device_ms": sum(p["device_ms"] or 0.0 for p in per),
                "plain_device_ms": sum(p["plain_device_ms"] or 0.0
                                       for p in per)} if is_fq else {}),
            **({"device_ms": sum(p["device_ms"] or 0.0 for p in per),
                "library_device_ms": sum(p["library_device_ms"] or 0.0
                                         for p in per)}
               if name in ("pack_cf", "unpack_cf", "unpack_frames") else {}),
            "serving_launches": serve["launches"][name],
            # one HVP batch of bit_assign --hvp_impl pallas (omega), one
            # fisher_diag batch on the production tail
            "stage2_hvp_batch_launches": stage2["runs"]["omega pallas"][
                "launches_per_batch"][name],
            "stage2_fisher_batch_launches": stage2["runs"]["fisher_diag"][
                "launches_per_batch"][name],
            "per_decode_launches": dec["launches"][name] // 4,
            # one stage-1 step (batch 1), as phase 12 counts it, and the
            # launches of phase 12's regress run (its steps and its evals)
            "per_stage1_step": s1step["launches"][name],
            "stage1_run_launches": s1run["launches"][name],
            # the fake-quant entries: per step of the phase that runs them
            "per_step_launches": (
                FQ_PHASE1[name] + FQ_PHASE2[name] if is_fq
                else PER_STEP[name]),
            # over phase 15's main path: both unit-scope runs, their evals,
            # the bitstream and the NeRV run
            "unit_scope_launches": unit["launches"][name],
            # over phase 16's runs in this process (one process and world
            # size 1), and on each of the two gloo ranks
            "dp_launches": dp["launches"][name],
            "dp_rank_launches": [r[name] for r in dp["rank_launches"]],
            "pnerv_dp_rank_launches": [r[name]
                                       for r in dp["pnerv_rank_launches"]],
            # over phase 17's surface and line
            "landscape_launches": land["launches"][name],
            "per_launch": per})
    kernels[0]["calibration_per_launch"] = brecords["tail_conv_cf"][
        "per_launch"]
    # the shape of the JAX width-tiled _unpack_kernel5, outside the sum;
    # pack_cf at the calibration step's batch, outside the decode's sum
    kernels[4]["width_tiled"] = records["unpack_frames"]["width_tiled"]
    kernels[2]["calibration_per_launch"] = records["pack_cf"][
        "calibration_per_launch"]
    # the stage-1 step's launches at batch 1, outside the sums
    for i, name in ((0, "tail_conv_cf"), (1, "tail_conv_dw_cf"),
                    (3, "unpack_cf")):
        kernels[i]["stage1_per_launch"] = s1records[name]["per_launch"]
    kernels[4]["stage1_per_launch"] = [s1unpack["forward"],
                                       s1unpack["backward"]]
    _add_model_records(kernels, nerv, "nerv")
    _add_model_records(kernels, pnerv, "pnerv")
    # the bf16 instantiations (phase 19): launches over its calibrate_network
    # and regress runs, summed as their fp32 rows are (per decode at batch
    # 1, per calibration step at batch 2)
    brec = bf["kernels"]
    bf_runs = (bf["calibrate"]["launches"], bf["stage1"]["launches"])
    for name, replaces, summed in (
            ("tail_conv_cf", tpu(1133), "per decode"),
            ("tail_conv_dw_cf", tpu(1172), "per step"),
            ("pack_cf", tpu(656), "per decode, from fp32"),
            ("unpack_cf", tpu(666), "per step, to bf16"),
            ("unpack_frames", tpu(2016), "per decode, to fp32")):
        per = brec[name]["per_launch"]
        t_ops = sum(p["bound_ms"] for p in per
                    if p["bound_by"] == "operations")
        t_bytes = sum(p["bound_ms"] for p in per if p["bound_by"] == "bytes")
        kernels.append({
            "name": name + "_bf16", "route": "cuda", "source": src(name),
            "replaces": replaces,
            "launches": sum(r[name + "_bf16"] for r in bf_runs),
            "calibrate_launches": bf_runs[0][name + "_bf16"],
            "regress_launches": bf_runs[1][name + "_bf16"],
            "max_abs_err": brec[name]["max_abs_err"],
            "ms": sum(p["ms"] for p in per),
            "plain_ms": sum(p["plain_ms"] for p in per),
            "bound_ms": sum(p["bound_ms"] for p in per),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": sum(p["library_ms"] for p in per),
            # the convs: the profiler's device time; the layout kernels: the
            # card's own time by the event method, hot and cold, None if a
            # launch's window was paced by the host
            **({k: sum(p[k] or 0.0 for p in per)
                for k in ("device_ms", "library_device_ms")}
               if name.startswith("tail_conv") else
               {k: None if any(p[k] is None for p in per)
                else sum(p[k] for p in per)
                for k in ("hot_ms", "cold_ms", "library_hot_ms",
                          "library_cold_ms")}),
            "summed": summed, "checks": brec[name]["checks"],
            **{k: v for k, v in brec[name].items()
               if k not in ("per_launch", "max_abs_err", "checks")},
            "per_launch": per})
        if name == "tail_conv_cf":
            # the forward and dx launches of one calibration step (batch 2)
            cal = brec[name]["calibration_per_launch"]
            kernels[-1].update(
                per_step_ms=sum(p["ms"] for p in cal),
                per_step_library_ms=sum(p["library_ms"] for p in cal),
                per_step_bound_ms=sum(p["bound_ms"] for p in cal))
    for k in kernels:
        assert k["launches"] > 0, k["name"]
    for k in ("tail_conv_cf", "pack_cf", "unpack_frames"):
        assert serve["launches"][k] > 0, k
    for k in ("tail_conv_cf", "pack_cf", "unpack_frames", "fq_uaq", "fq_ada",
              "fq_ada_bwd"):
        assert unit["launches"][k] > 0, k
    for k in ("tail_conv_cf", "tail_conv_dw_cf", "pack_cf", "unpack_cf",
              "unpack_frames", "fq_ada", "fq_ada_bwd"):
        assert dp["launches"][k] > 0, k
    for k in ("tail_conv_cf", "pack_cf", "unpack_frames"):
        assert land["launches"][k] > 0, k
    print(f"  total {time.time() - t_start:.1f} s after start; decode "
          f"{dec['decode_ms']:.3f} ms/frame kernel path, "
          f"{dec['plain_decode_ms']:.3f} plain; calibration phase 2 "
          f"{calib['phase2_its']} it/s; phases 16 / 17 / 18 "
          f"{dp['seconds']:.1f} / {land['seconds']:.1f} / "
          f"{bench['seconds']:.1f} s; phase 19 {bf['seconds']:.1f} s; "
          f"phase 20 {norm_acts['seconds']:.1f} s; card {card}")
    print(json.dumps({"card": card, "decode": dec, "serving": serve,
                      "step": grad, "calibrate": calib,
                      "quantize_params": frecords["quantize_params"],
                      "calibrate_fq_pallas": calib_fq, "bitstream": stream,
                      "stage2": stage2, "stage1_step": s1step,
                      "stage1": s1run,
                      "nerv": {k: v for k, v in nerv.items()
                               if not k.startswith(("kernels", "fq"))},
                      "pnerv": {k: v for k, v in pnerv.items()
                                if not k.startswith(("kernels", "fq"))},
                      "unit_scope": unit, "data_parallel": dp,
                      "loss_landscape": land, "bench": bench,
                      "bf16": {k: v for k, v in bf.items()
                               if k != "kernels"},
                      "dec_norm_and_activations": norm_acts}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
