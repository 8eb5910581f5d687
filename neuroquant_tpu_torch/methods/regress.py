"""Stage 1: fp32 per-video overfitting of HNeRV or NeRV, the
counterpart of ``neuroquant_tpu/methods/regress.py``: the same flags, config
keys, output-directory scheme, log lines and reference-layout ``.pth``
checkpoints.

Each step is the model's forward (encode the frames, HNeRV, or their
normalized indices, NeRV; then decode on the fused tail's CUDA kernels,
forward and backward), the loss, ``torch.optim.Adam`` and the
step's PSNR; the lr of each step is the schedule's at the count of earlier
updates. The clip stays on the device and each epoch's frame order comes
from a ``torch.Generator`` seeded from ``--seed``; per-step losses and PSNRs
stay on the device until the epoch ends. With ``--mesh_devices N`` the run
spawns N ranks (``parallel.launch``: NCCL, rank r on ``cuda:r``; gloo with
``--device cpu``) that split each step's frame batch and sum their
gradients before Adam; rank 0 evaluates, logs and writes the checkpoints.

Run (on the GPU; ``--device cpu`` for the CPU):
  python -m neuroquant_tpu_torch.methods.regress \\
      --config configs/HNeRV/Bunny_1280x640_3M.yaml --arch hnerv \\
      --data_path <frames> --vid Bunny --outf hnerv
  (NeRV: --config configs/NeRV/Bunny_1280x640_3M.yaml --arch nerv)
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time
from datetime import datetime

import numpy as np
import torch

from neuroquant_tpu_torch.config import get_config, validate_config
from neuroquant_tpu_torch.data import VideoDataSet
from neuroquant_tpu_torch.logging_utils import setup_logger
from neuroquant_tpu_torch.methods import common
from neuroquant_tpu_torch.metrics import loss_fn, psnr_fn_single
from neuroquant_tpu_torch.ops import precision as precision_mod
from neuroquant_tpu_torch.parallel.mesh import (
    all_reduce_sum, check_batch, data_parallel_step, is_main, launch,
    replicate, shard_batch)
from neuroquant_tpu_torch.schedules import make_lr_schedule
from neuroquant_tpu_torch.utils.convert import save_pth
from neuroquant_tpu_torch.utils.device import resolve_device, synchronize
from neuroquant_tpu_torch.utils.profiling import profile_trace, summarize_trace


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description="running parameters",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--seed", default=903, type=int,
                        help="random seed for results reproduction")
    parser.add_argument("--outf", default="unify",
                        help="folder to output images and model checkpoints")
    parser.add_argument("--config", type=str, help="config file path")
    parser.add_argument("--arch", type=str, help="the architecture of NeRV")
    parser.add_argument("--data_path", type=str, help="data path for vid")
    parser.add_argument("--vid", type=str, help="video id")
    parser.add_argument("--data_split", type=str, default="1_1_1",
                        help="Valid_train/total_train/all data split")
    parser.add_argument("-p", "--print-freq", default=50, type=int)
    parser.add_argument("--lr_type", type=str, default="cosine_0.1_1_0.1",
                        help="learning rate type, default=cosine")
    parser.add_argument("--weight", default="None", type=str,
                        help="model for test")
    parser.add_argument("--eval_only", action="store_true", default=False)
    parser.add_argument("--dump_vis", action="store_true", default=False)
    parser.add_argument("--eval_fps", action="store_true", default=False)
    parser.add_argument("--qat_mode", default="none", type=str,
                        choices=["none", "ffnerv", "hinerv"],
                        help="quantization-aware training of decoder weights")
    parser.add_argument("--qat_bits", default=8, type=int)
    parser.add_argument("--ckpt_freq", default=1, type=int,
                        help="save model_latest.pth every N epochs")
    parser.add_argument("--matmul_precision", default="default", type=str,
                        choices=["default", "tensorfloat32", "bfloat16",
                                 "highest"],
                        help="default and highest: fp32, TF32 off; "
                             "tensorfloat32: cuDNN and matmuls may use TF32 "
                             "(the tail kernels stay 3xTF32); bfloat16: "
                             "every conv and matmul on bf16 operands with "
                             "fp32 sums, the tail and fused prefix on the "
                             "kernels' bf16 instantiations "
                             "(ops/precision.py)")
    parser.add_argument("--profile", action="store_true", default=False,
                        help="write a torch.profiler trace of epoch 2 to "
                             "<outf>/profile and log the top kernels")
    parser.add_argument("--mesh_devices", default=0, type=int,
                        help="data-parallel training over N ranks (N "
                             "cards; gloo processes with --device cpu)")
    parser.add_argument("--snapshot_freq", default=0, type=int,
                        help="also save epoch{N}.pth every N epochs (0 = "
                             "final only)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    return args


@contextlib.contextmanager
def matmul_precision(precision: str, device):
    """'tensorfloat32' lets cuDNN and matmuls round fp32 operands to TF32
    on the card for the enclosed region; 'bfloat16' runs every conv and
    matmul on bf16 operands, and the fused tail and prefix on the kernels'
    bf16 instantiations, on any device (``ops.precision``, the port's
    definition: on the CPU the JAX package computes fp32); 'default' and
    'highest' keep the port's fp32 (TF32 off,
    ``utils.device.resolve_device``)."""
    if precision == "bfloat16":
        with precision_mod.matmul_precision("bfloat16"):
            yield
        return
    if precision != "tensorfloat32" or torch.device(device).type != "cuda":
        yield
        return
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def qat_transform(arch: str, cfg: dict, mode: str, bits: int):
    """params -> params with the decoder's conv weights QAT-fake-quantized
    (``ops.quant.qat_fake_quant`` on each weight in HWIO layout, as the JAX
    package stores it)."""
    from neuroquant_tpu_torch.models import quant_layer_paths
    from neuroquant_tpu_torch.ops.quant import qat_fake_quant
    from neuroquant_tpu_torch.utils.convert import layer_prefix

    keys = [layer_prefix(p, arch) + ".weight"
            for p in quant_layer_paths(arch, cfg)]

    def transform(params, generator=None, training=True):
        out = dict(params)
        for k in keys:
            q = qat_fake_quant(params[k].permute(2, 3, 1, 0), bits, mode,
                               generator=generator, training=training)
            out[k] = q.permute(3, 2, 0, 1)
        return out

    return transform


def epoch_order(train_ind, seed: int, epoch: int):
    """The epoch's shuffle of the training frames."""
    g = torch.Generator().manual_seed((int(seed) << 32) + epoch)
    t = torch.as_tensor(np.asarray(train_ind, np.int64))
    return t[torch.randperm(len(t), generator=g)]


def make_train_epoch(model, loss_type, opt, schedule, frames,
                     norm_idx, steps_per_epoch, batch_size,
                     qat_fn=None, qat_generator=None, mesh=None):
    """run_epoch(order, step0) -> (losses, psnrs), each (steps_per_epoch,)
    on the device: the epoch's batches are order[:steps * batch_size] in
    rows of batch_size; each step sets the lr to ``schedule(step0 + s)``,
    runs the forward (through `qat_fn`'s weights when it is given), the
    loss, the backward and Adam, and keeps the loss and the batch's mean
    PSNR of the step's prediction.

    With a data-parallel `mesh` each rank runs its rows of each batch, its
    loss and PSNR normalised by the global batch, and the gradients are
    summed over the ranks before Adam (a rank with no row contributes
    zeros, and still draws the step's QAT noise); the losses and PSNRs
    are summed over the ranks once an epoch."""
    check_batch(model, batch_size, mesh)
    params = dict(model.named_parameters())
    inputs = model.model_input(frames, norm_idx)
    leaves = list(params.values())

    def predict(inp):
        if qat_fn is None:
            return model(inp)
        return torch.func.functional_call(
            model, qat_fn(params, generator=qat_generator, training=True),
            (inp,))

    def local_step(idx, s, losses, psnrs):
        """This rank's forward, loss and backward on its rows `idx`; keeps
        the step's loss and PSNR."""
        if not len(idx):
            if qat_fn is not None:      # the same draws on every rank
                qat_fn(params, generator=qat_generator, training=True)
            return
        img = frames[idx]
        pred = predict(inputs[idx])
        loss = loss_fn(pred, img, loss_type)
        share = None if mesh is None else len(idx) / batch_size
        if share is not None:
            loss = loss * share
        loss.backward()
        with torch.no_grad():
            losses[s] = loss
            psnr = psnr_fn_single(pred, img).mean()
            psnrs[s] = psnr if share is None else psnr * share

    step = data_parallel_step(local_step, mesh, leaves)

    def run_epoch(order, step0: int):
        order = torch.as_tensor(np.array(order, np.int64),
                                device=frames.device)
        batches = order[:steps_per_epoch * batch_size].reshape(
            steps_per_epoch, batch_size)
        losses = frames.new_zeros(steps_per_epoch)
        psnrs = frames.new_zeros(steps_per_epoch)
        for s in range(steps_per_epoch):
            for group in opt.param_groups:
                group["lr"] = schedule(step0 + s)
            opt.zero_grad(set_to_none=True)
            step(shard_batch(batches[s], mesh), s, losses, psnrs)
            opt.step()
        if mesh is not None:
            both = all_reduce_sum(torch.stack([losses, psnrs]), mesh)
            losses, psnrs = both[0], both[1]
        return losses, psnrs

    return run_epoch


def _summary_writer(log_dir: str):
    """A TensorBoard writer, or None where TensorBoard is not installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


def _eval_line(epoch, hw, results, best, writer):
    print_str = f"Eval at epoch {epoch + 1} for {hw}: "
    for i, (name, value) in enumerate(zip(common.METRIC_NAMES, results)):
        best[i] = max(best[i], float(np.max(value)))
        digits = 2 if "psnr" in name else 4
        if "seen" in name and writer is not None and "unseen" not in name:
            writer.add_scalar(f"Val/{name}_{hw}", float(np.max(value)),
                              epoch + 1)
            writer.add_scalar(f"Val/best_{name}_{hw}", best[i], epoch + 1)
        print_str += f"{name}: {round(float(np.max(value)), digits)} | "
    logging.info(print_str)


def train(args, cfg, epoch_orders=None, mesh=None):
    """Stage 1 (or, with --eval_only, one evaluation); returns the model.
    epoch_orders(epoch) -> frame indices: the shuffles to use instead of
    the seeded generator's. With a data-parallel `mesh` every rank trains
    from rank 0's weights; rank 0 alone logs, evaluates and writes."""
    device = resolve_device(args.device)
    common.seed_all(args.seed)
    args.metric_names = common.METRIC_NAMES
    best_metric_list = [0.0] * len(common.METRIC_NAMES)

    dataset = VideoDataSet(cfg, args.data_path, device=device)
    train_ind = common.split_dataset(args, dataset)
    model = common.setup_run(args, cfg, device=device)
    writer = None
    if is_main(mesh):
        os.makedirs(args.outf, exist_ok=True)
        writer = _summary_writer(os.path.join(args.outf, "tensorboard"))
        setup_logger(os.path.join(args.outf,
                                  time.strftime("%Y%m%d_%H%M%S") + ".log"))
    logging.info("[PID] %s" % os.getpid())
    logging.info("================== Model Architecture=================")
    logging.info(f"{args.arch} / {model.cfg}")
    logging.info(f"Encoder_{round(args.encoder_param, 2)}M_"
                 f"Decoder_{round(args.decoder_param, 2)}M_"
                 f"Total_{round(args.total_param, 2)}M")

    if args.weight != "None":
        logging.info("=> loading checkpoint '{}'".format(args.weight))
        common.load_pth(args.weight, model)
    if mesh is not None:
        logging.info("data-parallel training over %d ranks (%s)",
                     mesh.size, mesh.device.type)
        if cfg["batch_size"] % mesh.size:
            logging.warning("batch_size %d not divisible by mesh_devices %d",
                            cfg["batch_size"], mesh.size)
        replicate([*model.parameters(), *model.buffers()], mesh)

    try:
        with matmul_precision(args.matmul_precision, device):
            if args.eval_only:
                if not is_main(mesh):
                    return model
                logging.info("Evaluation ... \n {} Results for checkpoint: "
                             "{}\n".format(datetime.now().strftime(
                                 "%Y_%m_%d_%H_%M_%S"), args.weight))
                results, _, _ = common.evaluate(model, dataset, args, cfg,
                                                args.dump_vis, args.eval_fps)
                print_str, _ = common.best_metrics_str(results,
                                                       best_metric_list)
                logging.info(print_str)
                return model
            _fit(args, cfg, model, dataset, train_ind, device, writer,
                 best_metric_list, epoch_orders, mesh)
    finally:
        if writer is not None:
            writer.close()
    return model


def _fit(args, cfg, model, dataset, train_ind, device, writer,
         best_metric_list, epoch_orders, mesh=None):
    args.lr = cfg["learning_rate"]
    bs = cfg["batch_size"]
    steps_per_epoch = len(train_ind) // bs
    total_steps = cfg["epoch"] * steps_per_epoch
    schedule = make_lr_schedule(args.lr_type, args.lr, total_steps)
    opt = torch.optim.Adam(model.parameters(), lr=schedule(0), eps=1e-8)

    qat_fn, qat_gen = None, None
    if args.qat_mode != "none":
        qat_fn = qat_transform(args.arch, cfg, args.qat_mode, args.qat_bits)
        qat_gen = torch.Generator(device=device).manual_seed(args.seed)
        logging.info(f"QAT enabled: mode={args.qat_mode} "
                     f"bits={args.qat_bits}")

    run_epoch = make_train_epoch(model, cfg["loss"], opt, schedule,
                                 dataset.frames, dataset.norm_idx,
                                 steps_per_epoch, bs, qat_fn, qat_gen, mesh)

    start = datetime.now()
    logging.info(f"begin training on {device.type}:"
                 f"{common.device_name(device)}")
    for epoch in range(cfg["epoch"]):
        epoch_start = datetime.now()
        order = (epoch_orders(epoch) if epoch_orders is not None
                 else epoch_order(train_ind, args.seed, epoch))
        step0 = epoch * steps_per_epoch
        if args.profile and epoch == 1:
            prof_dir = os.path.join(args.outf, "profile")
            with profile_trace(prof_dir):
                _, psnrs = run_epoch(order, step0)
                synchronize(device)
            for ms, name in summarize_trace(prof_dir, top_k=10):
                logging.info("[profile] %8.2f ms  %s", ms, name[:120])
        else:
            _, psnrs = run_epoch(order, step0)
        psnrs = psnrs.cpu().numpy()      # the epoch's one fetch

        lr_now = schedule((epoch + 1) * steps_per_epoch - 1)
        for i in (list(range(0, steps_per_epoch, args.print_freq))
                  + [steps_per_epoch - 1]):
            logging.info("[{}], Epoch[{}/{}], Step [{}/{}], lr:{:.2e} "
                         "pred_PSNR: {}".format(
                             datetime.now().strftime("%Y/%m/%d %H:%M:%S"),
                             epoch + 1, cfg["epoch"], i + 1, steps_per_epoch,
                             lr_now, round(float(psnrs[:i + 1].mean()), 2)))
        if writer is not None:
            h, w = cfg["crop_h"], cfg["crop_w"]
            writer.add_scalar(f"Train/pred_PSNR_{h}X{w}",
                              float(psnrs.mean()), epoch + 1)
            writer.add_scalar("Train/lr", lr_now, epoch + 1)
        epoch_end = datetime.now()
        logging.info("Time/epoch: \tCurrent:{:.2f} \tAverage:{:.2f}".format(
            (epoch_end - epoch_start).total_seconds(),
            (epoch_end - start).total_seconds() / (epoch + 1)))

        if not is_main(mesh):
            continue
        if ((epoch + 1) % cfg["eval_freq"] == 0
                or (cfg["epoch"] - epoch) in [1, 3, 5]):
            results, hw, _ = common.evaluate(
                model, dataset, args, cfg,
                args.dump_vis if epoch == cfg["epoch"] - 1 else False)
            _eval_line(epoch, hw, results, best_metric_list, writer)

        if ((epoch + 1) % args.ckpt_freq == 0
                or epoch == cfg["epoch"] - 1):
            save_pth(os.path.join(args.outf, "model_latest.pth"), model)
        snap = args.snapshot_freq
        if ((epoch + 1) % cfg["epoch"] == 0
                or (snap and (epoch + 1) % snap == 0)):
            save_pth(os.path.join(args.outf, f"epoch{epoch + 1}.pth"), model)

    logging.info(f"Training complete in: {str(datetime.now() - start)}")


def run(mesh, argv, epoch_orders=None):
    """One run of the CLI on `mesh` (None: one process) on this rank's
    device: the function each rank of ``--mesh_devices`` runs."""
    args = parse_args(argv)
    if mesh is not None:
        args.device = str(mesh.device)
    cfg = validate_config(get_config(args.config), args.arch)
    args.outf = os.path.join("results", args.outf)
    args.exp_id = common.exp_id(args, cfg)
    args.outf = os.path.join(args.outf, args.exp_id)
    return train(args, cfg, epoch_orders, mesh)


def main(argv, epoch_orders=None):
    """The trained model; with ``--mesh_devices N > 1`` the N ranks' run,
    and rank 0's model on the CPU (`epoch_orders` must then pickle)."""
    args = parse_args(argv)
    if args.mesh_devices > 1:
        return launch(run, args.mesh_devices, args.device,
                      (argv, epoch_orders))[0]
    return run(None, argv, epoch_orders)


if __name__ == "__main__":
    main(sys.argv[1:])
