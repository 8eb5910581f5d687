"""Stage 2: Omega mixed-precision bit allocation, the counterpart of
``neuroquant_tpu/methods/bit_assign.py``.

Evaluate the FP32 model, then for each candidate bit vector build a
QuantSpec, initialize its scales and score the perturbation with the Omega
Hessian criterion (or the diagonal Fisher); the lowest score wins. The
Hessian-vector product is reverse-over-forward (``quantization/
sensitivity.py``): with ``--hvp_impl pallas`` the decode runs
``fused_tail: pallas_hvp``, the fused tail's CUDA kernels carrying the
tangent (``ops/tail_fused.tail_apply_fo``); with ``--hvp_impl xla`` (the
default) ``fused_tail: off``, the plain unpacked decode on cuDNN.

Run (on the GPU; ``--device cpu`` for the CPU):
  python -m neuroquant_tpu_torch.methods.bit_assign \\
      --config configs/HNeRV/Bunny_1280x640_3M.yaml --arch hnerv \\
      --data_path <frames> --vid Bunny --outf hnerv --ckpt <epoch.pth> \\
      --batch_size 2 --channel_wise --init max --mode omega
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from datetime import datetime

import numpy as np

from neuroquant_tpu_torch.config import get_config, validate_config
from neuroquant_tpu_torch.data import VideoDataSet
from neuroquant_tpu_torch.logging_utils import setup_logger
from neuroquant_tpu_torch.methods import common
from neuroquant_tpu_torch.quantization import (
    average_bits, init_quant_state, make_spec, sensitivity_criterion,
)
from neuroquant_tpu_torch.quantization.qmodel import _get
from neuroquant_tpu_torch.utils.device import resolve_device

# toy candidate sets from the reference
HNERV_CANDIDATES = {
    "candidate1": [2, 3, 4, 6, 4, 4, 2],
    "candidate2": [6, 5, 4, 5, 5, 6, 6],
}
NERV_CANDIDATES = {
    "candidate1": [5, 6, 3, 4, 5, 4, 3],
    "candidate2": [6, 5, 5, 6, 7, 6, 7],
}


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
    parser.add_argument("--hadamard", action="store_true")
    parser.add_argument("--channel_wise", action="store_true")
    parser.add_argument("--init", default="max", type=str,
                        choices=["max", "mse", "gaussian", "l1", "l2"])
    parser.add_argument("--mode", default="omega", type=str,
                        choices=["omega", "fisher_diag"])
    parser.add_argument("--ckpt", default="None", type=str)
    parser.add_argument("--hvp_impl", default="xla", type=str,
                        choices=["pallas", "xla"],
                        help="HVP decode execution: 'xla' (default), the "
                             "plain unpacked decode on cuDNN convs; "
                             "'pallas', the fused tail's CUDA kernels "
                             "carrying the tangent (tail_apply_fo). "
                             "fisher_diag with 'pallas' runs the "
                             "production fused tail")
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint the HVP's forward-mode decode in "
                             "segments (prefix blocks or fusion stages, "
                             "then the tail layer by layer) and run the "
                             "tail's tangent GELU in pieces: the backward "
                             "recomputes one at a time. One batch-2 HVP on "
                             "--hvp_impl pallas peaked at 12262 -> 4855 MiB "
                             "at PNeRV1 Bunny-3M (0.21 -> 0.30 s) and 4077 "
                             "-> 2247 MiB at HNeRV Bunny-3M (0.104 -> 0.147 "
                             "s) on an NVIDIA H100 80GB HBM3 at 700 W "
                             "(scripts/torch_hvp_bench.py --remat)")
    parser.add_argument("--candidates", default="", type=str,
                        help="optional: semicolon-separated bit lists, e.g. "
                             "'6,5,4,5,5,6,6;2,3,4,6,4,4,2' (defaults to the "
                             "reference's toy candidates)")
    parser.add_argument("--search", default="", type=str,
                        choices=["", "lagrangian"],
                        help="omega-guided allocation SEARCH instead of "
                             "scoring a fixed candidate list: per-layer "
                             "score curves from uniform-bit HVPs -> "
                             "Lagrangian lambda-sweep proposals under "
                             "--target_avg_bits -> exact omega re-scoring "
                             "of the proposals (the criterion stays the "
                             "reference's, the search only nominates)")
    parser.add_argument("--target_avg_bits", default=5.0, type=float,
                        help="parameter-weighted average-bit budget for "
                             "--search")
    parser.add_argument("--bit_range", default=[2, 8], type=int, nargs=2,
                        help="inclusive per-layer bit range for --search")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def lagrangian_candidates(curves, p_l, bit_choices, target_avg: float,
                          n_keep: int = 4):
    """Bit allocations minimizing sum_l s_l(b_l) + lambda * sum_l p_l b_l
    over a lambda sweep, filtered to the average-bit budget.

    curves: {b: [s_l for each layer]} per-layer omega scores at uniform-b
    allocations (block-diagonal surrogate of the joint criterion); p_l:
    per-layer parameter counts. Returns up to n_keep allocations on the
    budget's efficient edge (highest average bits <= target), always
    including the best-scoring single proposal."""
    p = np.asarray(p_l, np.float64)
    p_frac = p / p.sum()
    n_layers = len(p_l)
    seen = {}
    for lam in np.logspace(-8, 4, 200):
        bits = [min(bit_choices,
                    key=lambda b: curves[b][l] + lam * p_frac[l] * b)
                for l in range(n_layers)]
        avg = float((p * np.asarray(bits)).sum() / p.sum())
        if avg <= target_avg + 1e-9:
            surrogate = float(sum(curves[b][l] for l, b in enumerate(bits)))
            seen[tuple(bits)] = (avg, surrogate)
    if not seen:
        lo = min(bit_choices)
        return [[lo] * n_layers]
    ranked = sorted(seen.items(), key=lambda kv: -kv[1][0])  # avg desc
    keep = [list(k) for k, _ in ranked[:n_keep]]
    best_sur = min(seen.items(), key=lambda kv: kv[1][1])[0]
    if list(best_sur) not in keep:
        keep.append(list(best_sur))
    return keep


def _spec(args, cfg, bits=None):
    spec = make_spec(args.arch, cfg, channel_wise=args.channel_wise,
                     scale_method=args.init, hadamard=args.hadamard)
    return spec if bits is None else spec.with_bits(bits)


def assign(args, cfg):
    device = resolve_device(args.device)
    common.seed_all(args.seed)
    args.metric_names = common.METRIC_NAMES

    dataset = VideoDataSet(cfg, args.data_path, device=device)
    common.split_dataset(args, dataset)

    # fisher_diag is a plain gradient: with --hvp_impl pallas it runs on the
    # production fused tail
    cfg["fused_tail"] = ("off" if args.hvp_impl == "xla" else
                         "pallas_hvp" if args.mode == "omega" else "auto")
    model = common.setup_run(args, cfg, device=device)
    args.outf = os.path.join(
        args.outf, "sensitivity-{}_{}-init_batch{}_CW".format(
            args.mode, args.init, args.batch_size))
    os.makedirs(args.outf, exist_ok=True)
    setup_logger(os.path.join(args.outf,
                              time.strftime("%Y%m%d_%H%M%S") + ".log"))

    assert args.ckpt != "None"
    logging.info("=> loading checkpoint '{}'".format(args.ckpt))
    common.load_pth(args.ckpt, model)
    model.eval()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}

    logging.info("=======================Full-precision model"
                 "========================")
    print_str = "Evaluation ... \n {} Results for checkpoint: {}\n".format(
        datetime.now().strftime("%Y_%m_%d_%H_%M_%S"), args.ckpt)
    results, _, _ = common.evaluate(model, dataset, args, cfg)
    s, _ = common.best_metrics_str(results)
    logging.info(print_str + s)

    def score(spec, log_fn=logging.info):
        return sensitivity_criterion(
            args.mode, args.arch, model, params, spec,
            init_quant_state(params, spec), dataset.frames, dataset.norm_idx,
            args.batch_size, seed=args.seed, log_fn=log_fn, remat=args.remat)

    if args.search == "lagrangian":
        # per-layer omega curves from uniform-bit allocations: (Hv)_l . v_l
        # under the joint uniform-b perturbation
        bit_choices = list(range(args.bit_range[0], args.bit_range[1] + 1))
        n_layers = _spec(args, cfg).num_layers
        curves = {}
        for b in bit_choices:
            _, per_layer = score(_spec(args, cfg, [b] * n_layers),
                                 log_fn=lambda s: None)
            curves[b] = per_layer
            logging.info(f"[search] uniform W{b}: per-layer "
                         + " ".join(f"{v:.2e}" for v in per_layer))
        p_l = [sum(int(t.numel()) for t in _get(params, pre))
               for pre in _spec(args, cfg).layer_keys]
        cands = lagrangian_candidates(curves, p_l, bit_choices,
                                      args.target_avg_bits)
        candidate_dict = {f"lagrangian{i + 1}": c
                          for i, c in enumerate(cands)}
        logging.info(f"[search] {len(cands)} proposals under avg "
                     f"{args.target_avg_bits}: {cands}")
    elif args.candidates:
        candidate_dict = {
            f"candidate{i + 1}": [int(b) for b in c.split(",")]
            for i, c in enumerate(args.candidates.split(";"))}
    elif args.arch.lower() == "hnerv":
        candidate_dict = HNERV_CANDIDATES
    elif args.arch.lower() == "nerv":
        candidate_dict = NERV_CANDIDATES
    else:
        # PNeRV: no toy candidates in the reference
        raise ValueError(f"no default candidates for arch {args.arch}")

    best_score, best_candidate, best_bits = float("inf"), None, None
    for candidate, bits in candidate_dict.items():
        spec = _spec(args, cfg, bits)
        avg_bits = average_bits(params, spec)
        logging.info(f"[{candidate}: {bits}] Average Quantization Bit-Width:\t"
                     f"{avg_bits:.4f}")
        total, _ = score(spec)
        logging.info(f"[{candidate}: {bits}] The {args.mode} sensitivity "
                     f"score =\t{total:.3e}")
        if total < best_score:
            best_score, best_candidate, best_bits = total, candidate, bits

    logging.info("=" * 60)
    logging.info(f"Best Candidate: {best_candidate}")
    logging.info(f"Bit Configuration: {best_bits}")
    logging.info(f"Minimum Score: {best_score:.4e}")
    logging.info("=" * 60)
    return best_candidate, best_bits, best_score


def main(argv):
    args = parse_args(argv)
    cfg = validate_config(get_config(args.config), args.arch)
    args.outf = os.path.join("results", args.outf)
    args.exp_id = common.exp_id(args, cfg)
    args.outf = os.path.join(args.outf, args.exp_id)
    return assign(args, cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
