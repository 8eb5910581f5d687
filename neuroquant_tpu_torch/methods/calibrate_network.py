"""Stage 3: network-wise PTQ calibration (scales + AdaRound against the
ground-truth frames), the counterpart of
``neuroquant_tpu/methods/calibrate_network.py``.

Evaluate FP32, encode the calibration embeddings, quantize with the
per-layer --precision, evaluate quant-off and quant-on-unoptimized, run the
two-phase calibration (quantization/calibrate.py), or with --scope
block|layer the per-unit reconstruction (quantization/calib_unit.py; NeRV
and HNeRV), evaluate
quant-on-optimized, and save the quantized artifact: a pickle with the
reference-layout FP32 state dict, the quantization spec and state and the
integer codes, in the JAX package's format, which both packages'
``eval_quantized`` read.

With ``--mesh_devices N`` (network scope) the run spawns N ranks
(``parallel.launch``: NCCL, rank r on ``cuda:r``; gloo with ``--device
cpu``) that split each step's frame batch and sum their gradients; rank 0
evaluates, logs and writes the checkpoint and the artifact.

Run (on the GPU; ``--device cpu`` for the CPU):
  python -m neuroquant_tpu_torch.methods.calibrate_network \\
      --config configs/HNeRV/Bunny_1280x640_3M.yaml --arch hnerv \\
      --data_path <frames> --vid Bunny --outf hnerv --ckpt <epoch.pth> \\
      --precision 6 5 4 5 5 6 6 --hadamard --channel_wise --batch_size 2 \\
      --iters_w 21000 --lr 0.003 --warmup 0.2 [--mesh_devices 2]
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import sys
import time
from datetime import datetime

import numpy as np
import torch

from neuroquant_tpu_torch.config import get_config, validate_config
from neuroquant_tpu_torch.data import VideoDataSet
from neuroquant_tpu_torch.logging_utils import setup_logger
from neuroquant_tpu_torch.methods import common
from neuroquant_tpu_torch.methods.eval_quantized import params_from_codes
from neuroquant_tpu_torch.parallel.mesh import is_main, launch
from neuroquant_tpu_torch.quantization import (
    average_bits, collect_int_codes, init_quant_state, make_spec,
    model_reconstruction, quantize_params,
)
from neuroquant_tpu_torch.quantization.qmodel import _get
from neuroquant_tpu_torch.utils.convert import is_block_norm
from neuroquant_tpu_torch.utils.device import resolve_device, synchronize


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description="running parameters",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--seed", default=903, type=int)
    parser.add_argument("--outf", default="unify")
    parser.add_argument("--config", type=str)
    parser.add_argument("--arch", type=str)
    parser.add_argument("-p", "--print-freq", default=50, type=int)
    parser.add_argument("--data_path", type=str)
    parser.add_argument("--vid", type=str)
    parser.add_argument("--data_split", type=str, default="1_1_1")
    parser.add_argument("--batch_size", default=12, type=int)
    parser.add_argument("--precision", type=int, nargs="+",
                        default=[8, 8, 8, 8, 8, 8, 8])
    parser.add_argument("--channel_wise", action="store_true")
    parser.add_argument("--hadamard", action="store_true")
    parser.add_argument("--iters_w", default=20000, type=int)
    parser.add_argument("--weight", default=0.01, type=float)
    parser.add_argument("--b_start", default=20, type=int)
    parser.add_argument("--b_end", default=2, type=int)
    parser.add_argument("--warmup", default=0.2, type=float)
    parser.add_argument("--input_prob", default=1.0, type=float,
                        help="QDrop input mixing; unit (block/layer) "
                             "reconstruction only")
    parser.add_argument("--lr", default=0.0015, type=float)
    parser.add_argument("--adaround_layers", default=None, type=int,
                        nargs="+",
                        help="mixed rounding: AdaRound only these layer "
                             "indices (quant-traversal order); the rest "
                             "save round-to-nearest codes with their "
                             "phase-1 scales")
    parser.add_argument("--rounding", default="adaround", type=str,
                        choices=["adaround", "nearest"],
                        help="'adaround': scales then learned rounding; "
                             "'nearest': phase-1 scales only, "
                             "round-to-nearest codes")
    parser.add_argument("--norm_p", default=2.0, type=float)
    parser.add_argument("--init", default="max", type=str,
                        choices=["max", "mse", "gaussian", "l1", "l2"])
    parser.add_argument("--opt_mode", default="mse", type=str,
                        choices=["mse", "fisher_diag", "fisher_full"])
    parser.add_argument("--ckpt", default="None", type=str)
    parser.add_argument("--scope", default="network", type=str,
                        choices=["network", "block", "layer"])
    parser.add_argument("--dump_vis", action="store_true", default=False)
    parser.add_argument("--compute_dtype", default="float32", type=str,
                        choices=["float32", "bfloat16"],
                        help="network scope: the calibration decode's dtype "
                             "(bfloat16: the tail on the kernels' bf16 "
                             "instantiations; the quantization stays fp32); "
                             "--scope block|layer ignores it, as in JAX")
    parser.add_argument("--unit_cache", default="stream", type=str,
                        choices=["stream", "shared"],
                        help="block/layer scope only")
    parser.add_argument("--calib_ckpt_freq", default=25, type=int,
                        help="phase-2 resume checkpoint every N epochs (0 "
                             "disables; resumed automatically)")
    parser.add_argument("--cf_loss", default="auto", type=str,
                        choices=["auto", "on", "off"],
                        help="calibration loss in the packed channels-first "
                             "domain (decode_cf vs pre-packed frames)")
    parser.add_argument("--fq_impl", default="jnp", type=str,
                        choices=["jnp", "pallas"],
                        help="weight fake-quant implementation: 'jnp', the "
                             "plain tensor chain; 'pallas', the fused CUDA "
                             "kernel")
    parser.add_argument("--mesh_devices", default=0, type=int,
                        help="data-parallel calibration over N ranks (N "
                             "cards; gloo processes with --device cpu); "
                             "network scope only")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    if args.scope == "network":
        if args.opt_mode != "mse":
            parser.error(
                f"--opt_mode {args.opt_mode} is not supported for "
                "network-wise calibration (no FP-gradient cache exists at "
                "network scope); use --scope block|layer for fisher "
                "objectives")
        if args.input_prob != 1.0:
            parser.error(
                "--input_prob != 1.0 (QDrop) only applies to unit "
                "reconstruction (--scope block|layer)")
    elif args.mesh_devices > 1:
        parser.error("--mesh_devices applies to network-wise calibration "
                     "only (unit reconstruction minibatches cached tensors)")
    if args.rounding == "nearest" and args.scope != "network":
        parser.error("--rounding nearest is a network-scope mode")
    if args.adaround_layers is not None and (args.scope != "network"
                                             or args.rounding != "adaround"):
        parser.error("--adaround_layers requires --scope network and "
                     "--rounding adaround")
    return args


def _eval_block(title, model, params, dataset, args, cfg, dump_vis=False,
                mesh=None):
    """Evaluate the clip with `params` loaded into `model` and log the
    results. `dump_vis` writes the decoded frames under
    ``<outf>/visualize_calib_network``. On a data-parallel rank other than
    0 it does nothing."""
    if not is_main(mesh):
        return
    logging.info(f"======================={title}========================")
    model.load_state_dict(params)
    results, _, _ = common.evaluate(
        model, dataset, args, cfg, dump_vis,
        visual_dir_name="visualize_calib_network")
    print_str = "Evaluation ... \n {} \n".format(
        datetime.now().strftime("%Y_%m_%d_%H_%M_%S"))
    s, _ = common.best_metrics_str(results)
    logging.info(print_str + s)


def _unit_scope(args, model, params, spec, state, cali_data):
    """The BRECQ/AdaRound per-unit baselines: each quantized conv, in
    quant-traversal order, reconstructed against its cached FP output
    (``quantization/calib_unit.py``); --iters_w steps per unit. The
    ``shared`` cache harvests every unit's IO once in fp32, ``stream`` one
    unit's at a time in bf16."""
    from neuroquant_tpu_torch.quantization.calib_unit import (
        harvest_unit_io, unit_reconstruction)

    if args.arch.lower() not in ("hnerv", "nerv"):
        raise SystemExit(f"--scope {args.scope}: unit reconstruction covers "
                         "the NeRV/HNeRV decoder layout only")
    io, cache_dtype = None, None
    if args.unit_cache == "shared":
        t0 = time.time()
        io = harvest_unit_io(model, params, args.arch, spec, cali_data)
        synchronize(cali_data.device)
        logging.info("Cached init time: {}".format(time.time() - t0))
    else:
        cache_dtype = torch.bfloat16
    for u in range(len(spec.layer_names)):
        logging.info(f"Reconstruction for {args.scope} {u} "
                     f"({spec.layer_names[u]})")
        state = unit_reconstruction(
            model, params, spec, state, u, cali_data,
            include_act=(args.scope == "block"),
            batch_size=args.batch_size, iters=args.iters_w,
            weight=args.weight, b_range=(args.b_start, args.b_end),
            warmup=args.warmup, p=args.norm_p, lr=args.lr, seed=args.seed,
            opt_mode=args.opt_mode, input_prob=args.input_prob, io=io,
            cache_dtype=cache_dtype)
    return state


def _np(tree):
    """A nested dict of tensors as numpy (ints stay ints)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def calibrate(args, cfg, mesh=None):
    """The stage-3 run; returns (artifact path, calibrated state, spec).
    With a data-parallel `mesh` every rank runs it and encodes the clip;
    rank 0 alone evaluates, logs and writes."""
    device = resolve_device(args.device)
    common.seed_all(args.seed)
    args.metric_names = common.METRIC_NAMES

    dataset = VideoDataSet(cfg, args.data_path, device=device)
    train_ind = common.split_dataset(args, dataset)

    model = common.setup_run(args, cfg, device=device)
    args.outf = os.path.join(
        args.outf,
        "{}-wise_calib/hadamard-{}_{}-init_batch{}_CW_weight{}_brange{}-{}"
        "_warmup{}_lr{}".format(
            args.scope, args.hadamard, args.init, args.batch_size,
            args.weight, args.b_start, args.b_end, args.warmup, args.lr))
    if is_main(mesh):
        os.makedirs(args.outf, exist_ok=True)
        setup_logger(os.path.join(args.outf,
                                  time.strftime("%Y%m%d_%H%M%S") + ".log"))
    logging.info("[PID] %s" % os.getpid())
    if mesh is not None:
        logging.info("data-parallel calibration over %d ranks (%s)",
                     mesh.size, mesh.device.type)
        if args.batch_size % mesh.size:
            logging.warning(
                "batch_size %d not divisible by mesh_devices %d: uneven "
                "shards; prefer batch_size a multiple of the mesh",
                args.batch_size, mesh.size)

    assert args.ckpt != "None"
    logging.info("=> loading checkpoint '{}'".format(args.ckpt))
    common.load_pth(args.ckpt, model)
    model.eval()
    # the FP32 weights the fake-quant reads: a copy, since the eval blocks
    # load other weights into the model
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}

    _eval_block("Full-precision model", model, params, dataset, args, cfg,
                args.dump_vis, mesh)
    # every rank encodes the clip, in the evaluation's batches
    cali_data = common.encode_clip(model, dataset, cfg["batch_size"])
    logging.info("input embedding shape: {}".format(tuple(cali_data.shape)))

    spec = make_spec(args.arch, cfg, channel_wise=args.channel_wise,
                     scale_method=args.init, hadamard=args.hadamard,
                     fq_impl=args.fq_impl).with_bits(args.precision)
    args.qbits = average_bits(params, spec)

    init_start = time.time()
    state = init_quant_state(params, spec)
    logging.info("Init time: {}".format(time.time() - init_start))

    _eval_block("Close quantization model", model, params, dataset, args,
                cfg, mesh=mesh)
    with torch.no_grad():
        qparams = quantize_params(params, spec, state, mode="uaq")
    _eval_block("Weight quantization model w/o opt", model, qparams,
                dataset, args, cfg, mesh=mesh)

    logging.info("======================= Hyper Parameters "
                 "=======================")
    for k in ("init", "channel_wise", "seed", "iters_w", "batch_size",
              "weight", "input_prob", "qbits"):
        logging.info("{}: {}".format(k, getattr(args, k, None)))
    logging.info(f"========================== {args.arch} "
                 f"==========================")

    cf_pack = None
    if args.cf_loss != "off" and args.scope == "network":
        # the loss in the packed channels-first domain (decode_cf against
        # pre-packed frames): the same sum, without the per-step unpack
        from neuroquant_tpu_torch.models import tail_plan_for
        from neuroquant_tpu_torch.ops.tail_fused import (
            border_mask, pack_targets)
        tp = tail_plan_for(args.arch, cfg)
        if tp is not None:
            plan, f, ch = tp
            cf_pack = {"gt": pack_targets(dataset.frames, plan, f),
                       "mask": border_mask(plan, ch=ch, device=device),
                       "denom": cfg["crop_h"] * cfg["crop_w"]}
            logging.info("cf_loss: packed-domain calibration loss on (f=%d, "
                         "Mp=%d)", f, plan.mp)
        elif args.cf_loss == "on":
            raise SystemExit("--cf_loss on: no packed GELU tail for this "
                             "arch/config (use --cf_loss off)")

    model.load_state_dict(params)
    start = datetime.now()
    if args.scope == "network":
        state, mode = model_reconstruction(
            model, params, spec, state, cali_data, dataset.frames,
            train_ind, arch=args.arch, batch_size=args.batch_size,
            iters=args.iters_w, weight=args.weight,
            b_range=(args.b_start, args.b_end), warmup=args.warmup,
            p=args.norm_p, lr=args.lr, seed=args.seed,
            checkpoint_path=(os.path.join(args.outf, "calib_resume.pkl")
                             if args.calib_ckpt_freq else None),
            ckpt_every_epochs=max(args.calib_ckpt_freq, 1), cf_pack=cf_pack,
            rounding=args.rounding,
            adaround_only=(tuple(spec.layer_names[i]
                                 for i in args.adaround_layers)
                           if args.adaround_layers is not None else None),
            mesh=mesh,
            compute_dtype=(torch.bfloat16 if args.compute_dtype == "bfloat16"
                           else None))
    else:
        state = _unit_scope(args, model, params, spec, state, cali_data)
        mode = "adaround"
    logging.info(f"Training complete in: {str(datetime.now() - start)}")
    if not is_main(mesh):
        return None, state, spec

    with torch.no_grad():
        qparams = quantize_params(params, spec, state, mode=mode, soft=False)
    _eval_block("Weight quantization model w/ opt", model, qparams, dataset,
                args, cfg, args.dump_vis)

    codes = collect_int_codes(params, spec, state, mode=mode)

    # finiteness guard: a NaN alpha silently flips hard rounding to floor
    # (NaN >= 0 is False); refuse to ship a poisoned artifact
    bad = []
    for ln, s in state.items():
        for k, v in s.items():
            n_bad = int(v.numel()) - int(torch.isfinite(v).sum())
            if n_bad:
                bad.append(f"{ln}/{k}: {n_bad} non-finite")
    if bad:
        raise SystemExit("refusing to save artifact — non-finite quant "
                         "state:\n  " + "\n  ".join(bad))

    # roundtrip guard: weights rebuilt from codes + scales alone must match
    # the fake-quantized decode weights
    rt = params_from_codes(params, spec, codes)
    for name, pre in zip(spec.layer_names, spec.layer_keys):
        for a, b, leaf in zip(_get(qparams, pre), _get(rt, pre),
                              ("kernel", "bias")):
            err = float((a - b).abs().max())
            if err > 1e-5:
                raise SystemExit(
                    f"artifact roundtrip mismatch at {name}/{leaf}: "
                    f"max|fakequant - dequant(codes)| = {err}")
    artifact = {
        "arch": args.arch,
        "mode": mode,
        "cfg": cfg,
        # as the JAX package writes it: no decoder block's norm
        "state_dict": {k: v.cpu().numpy() for k, v in params.items()
                       if not is_block_norm(k)},
        "quant_spec": {
            "layer_names": spec.layer_names, "layer_paths": spec.layer_paths,
            "n_bits": spec.n_bits, "channel_wise": spec.channel_wise,
            "scale_method": spec.scale_method, "hadamard": spec.hadamard,
            "sym": spec.sym,
        },
        "quant_state": _np(state),
        "int_codes": _np(codes),
        "avg_bits": float(args.qbits),
        # the per-frame embeddings, the content half of the bitstream: none
        # for NeRV, whose input is the frame index
        "embeddings": (cali_data.detach().cpu().numpy()
                       if args.arch.lower() != "nerv" else None),
    }
    suffix = "CW" if args.channel_wise else "LW"
    out_path = "{}/{}_W{}_prob{}_{}-init_{}.pth".format(
        args.outf, args.arch, args.qbits, args.input_prob, args.init, suffix)
    logging.info("save quantized model in {}".format(args.outf))
    with open(out_path, "wb") as f:
        pickle.dump(artifact, f)
    return out_path, state, spec


def run(mesh, argv):
    """One run of the CLI on `mesh` (None: one process): parse, set up, and
    calibrate on this rank's device. The function each rank of
    ``--mesh_devices`` runs."""
    args = parse_args(argv)
    if mesh is not None:
        args.device = str(mesh.device)
    cfg = validate_config(get_config(args.config), args.arch)
    args.outf = os.path.join("results", args.outf)
    args.exp_id = common.exp_id(args, cfg)
    args.outf = os.path.join(args.outf, args.exp_id)
    return calibrate(args, cfg, mesh)


def main(argv):
    """(artifact path, calibrated state, spec); with ``--mesh_devices N >
    1`` the N ranks' run, and rank 0's result with its tensors on the
    CPU."""
    args = parse_args(argv)
    if args.mesh_devices > 1:
        return launch(run, args.mesh_devices, args.device, (argv,))[0]
    return run(None, argv)


if __name__ == "__main__":
    main(sys.argv[1:])
