"""Machinery shared by the CLI stages (the counterpart of
``neuroquant_tpu/methods/common.py``): run set-up and seeding, the model's
input, checkpoint loading, whole-clip PSNR/MS-SSIM in frame order with the
reference's ``Eval at Step`` log lines (and, with ``dump_vis``, every
decoded frame written as a PNG), and decode FPS."""

from __future__ import annotations

import logging
import os
import random
import time
from datetime import datetime

import numpy as np
import torch

from neuroquant_tpu_torch.metrics import msssim_fn_single, psnr_fn_single
from neuroquant_tpu_torch.schedules import data_split

METRIC_NAMES = ["pred_seen_psnr", "pred_seen_ssim",
                "pred_unseen_psnr", "pred_unseen_ssim"]


@torch.no_grad()
def measure_decode_fps(model, embeds, batch_size: int = 1,
                       n_iters: int = 400, reps: int = 4) -> float:
    """Decode throughput over `n_iters` sequential decodes of rotating frame
    embeddings, best of `reps` timed windows after one warm-up window. On
    the GPU the window is timed with CUDA events and ends in a
    synchronize; on the CPU with the host clock."""
    n = embeds.shape[0]
    idx = np.arange(n_iters * batch_size) % n
    batches = [embeds[torch.as_tensor(idx[i * batch_size:(i + 1) * batch_size],
                                      device=embeds.device)]
               for i in range(n_iters)]
    cuda = embeds.device.type == "cuda"

    def window() -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for e in batches:
            model.decode(e)
        if cuda:
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / 1e3
        return time.perf_counter() - t0

    window()                                  # warm-up (first launches)
    best = min(window() for _ in range(reps))
    return n_iters * batch_size / best


def _eval_fps_line(device, fps: float, bs: int) -> None:
    logging.info("[eval_fps] {} decode throughput: {} FPS (batch {})"
                 .format(device_name(device), round(fps, 1), bs))


@torch.no_grad()
def encode_clip(model, dataset, bs: int):
    """The clip's embeddings in frame order, encoded in batches of `bs` (as
    :func:`evaluate` encodes them)."""
    inputs = model.model_input(dataset.frames, dataset.norm_idx)
    return torch.cat([model.encode(inputs[i:i + bs])
                      for i in range(0, len(dataset), bs)])


@torch.no_grad()
def evaluate(model, dataset, args, cfg, dump_vis: bool = False,
             eval_fps: bool = False,
             visual_dir_name: str = "visualize_fp32"):
    """Full-clip eval in frame order: encode, decode and score each batch.
    Returns (results_list, (h, w), embeddings in frame order). Decode FPS
    is measured on the collected embeddings, as in the JAX package. With
    `dump_vis` the host loop of :func:`_evaluate_vis` runs instead."""
    if dump_vis:
        return _evaluate_vis(model, dataset, args, cfg, eval_fps,
                             visual_dir_name)
    frames = dataset.frames
    n = len(dataset)
    bs = cfg["batch_size"]
    val_ind = set(args.val_ind_list)
    n_batches = (n + bs - 1) // bs
    all_embeds = encode_clip(model, dataset, bs)
    ps, ss = [], []
    for i in range(n_batches):
        idx = slice(i * bs, min((i + 1) * bs, n))
        img = frames[idx]
        out = model.decode(all_embeds[idx])
        ps.append(psnr_fn_single(out, img))
        ss.append(msssim_fn_single(out, img))
    ps = torch.cat(ps).cpu().numpy()
    ss = torch.cat(ss).cpu().numpy()
    fps = measure_decode_fps(model, all_embeds, bs, n_iters=min(400, 4 * n))

    metric_list = [[] for _ in METRIC_NAMES]
    for frame_id in range(n):
        start = 2 if frame_id in val_ind else 0
        metric_list[start + 0].append(ps[frame_id])
        metric_list[start + 1].append(ss[frame_id])

    seen_mask = np.array([f not in val_ind for f in range(n)])
    for i in list(range(0, n_batches, args.print_freq)) + [n_batches - 1]:
        upto = min((i + 1) * bs, n)
        m = seen_mask[:upto]
        p = ps[:upto][m].mean() if m.any() else 0.0
        s = ss[:upto][m].mean() if m.any() else 0.0
        logging.info("[{}], Eval at Step [{}/{}], FPS {}, PSNR {}, MS-SSIM {}"
                     .format(datetime.now().strftime("%Y/%m/%d %H:%M:%S"),
                             i + 1, n_batches, round(fps, 1),
                             round(float(p), 2), round(float(s), 4)))

    results = [np.mean(v) if len(v) else np.zeros(1) for v in metric_list]
    args.fps = fps
    if eval_fps:
        _eval_fps_line(all_embeds.device, fps, bs)
    return results, (cfg["crop_h"], cfg["crop_w"]), all_embeds


def _evaluate_vis(model, dataset, args, cfg, eval_fps: bool,
                  visual_dir_name: str):
    """:func:`evaluate` as a host loop that writes each decoded frame to
    ``<outf>/<visual_dir_name>/pred_<frame id>_<PSNR>.png``. Its ``Eval at
    Step`` lines carry the running means and the FPS of the decodes timed
    one by one; with `eval_fps`, the decode FPS of
    :func:`measure_decode_fps` as well."""
    from PIL import Image

    frames = dataset.frames
    inputs = model.model_input(frames, dataset.norm_idx)
    n = len(dataset)
    bs = cfg["batch_size"]
    val_ind = set(args.val_ind_list)
    visual_dir = os.path.join(args.outf, visual_dir_name)
    logging.info(f"Saving predictions to {visual_dir}...")
    os.makedirs(visual_dir, exist_ok=True)
    cuda = frames.device.type == "cuda"

    metric_list = [[] for _ in METRIC_NAMES]
    embeds, dec_times = [], []
    n_batches = (n + bs - 1) // bs
    fps = 0.0
    for i in range(n_batches):
        idx = slice(i * bs, min((i + 1) * bs, n))
        img = frames[idx]
        emb = model.encode(inputs[idx])
        if cuda:
            torch.cuda.synchronize(frames.device)
        t0 = time.perf_counter()
        out = model.decode(emb)
        if cuda:
            torch.cuda.synchronize(frames.device)
        dec_times.append(time.perf_counter() - t0)
        embeds.append(emb)

        psnr = psnr_fn_single(out, img).cpu().numpy()
        msssim = msssim_fn_single(out, img).cpu().numpy()
        ids = range(idx.start, idx.stop)
        for bi, frame_id in enumerate(ids):
            start = 2 if frame_id in val_ind else 0
            metric_list[start + 0].append(psnr[bi])
            metric_list[start + 1].append(msssim[bi])
        arr = (torch.clamp(out, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        for bi, frame_id in enumerate(ids):
            tag = str(round(float(psnr[bi]), 2))
            Image.fromarray(arr[bi]).save(os.path.join(
                visual_dir, f"pred_{frame_id:04d}_{tag}.png"))

        if i % args.print_freq == 0 or i == n_batches - 1:
            fps = bs / (sum(dec_times) / len(dec_times))
            p = np.mean(metric_list[0]) if metric_list[0] else 0.0
            s = np.mean(metric_list[1]) if metric_list[1] else 0.0
            logging.info("[{}], Eval at Step [{}/{}], FPS {}, PSNR {}, "
                         "MS-SSIM {}".format(
                             datetime.now().strftime("%Y/%m/%d %H:%M:%S"),
                             i + 1, n_batches, round(fps, 1),
                             round(float(p), 2), round(float(s), 4)))

    results = [np.mean(v) if len(v) else np.zeros(1) for v in metric_list]
    args.fps = fps
    all_embeds = torch.cat(embeds)
    if eval_fps:
        args.fps = measure_decode_fps(model, all_embeds, bs)
        _eval_fps_line(all_embeds.device, args.fps, bs)
    return results, (cfg["crop_h"], cfg["crop_w"]), all_embeds


def device_name(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def seed_all(seed: int = 903):
    """Seed Python, numpy and torch; returns a torch.Generator on `seed`
    (the JAX function returns a PRNGKey)."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def setup_run(args, cfg, device=None):
    """Build the model (weights from ``args.seed``; NeRV's cfg gains
    ``n_frames``), count its parameters and append the reference's
    ``Encoder_..M_Decoder_..M_Total_..M`` directory to ``args.outf``."""
    from neuroquant_tpu_torch.models import build_model, param_counts

    if args.arch.lower() == "nerv":
        # the position encoding's exact table over the frame grid; set in
        # place, so that the caller's cfg (and the artifact) carry it
        cfg["n_frames"] = args.full_data_length
    model = build_model(args.arch, cfg, device=device, seed=args.seed)
    final_size = cfg["crop_h"] * cfg["crop_w"]
    enc_p, dec_p, tot_p = param_counts(args.arch, cfg, model, final_size,
                                       args.full_data_length)
    args.encoder_param, args.decoder_param, args.total_param = (
        enc_p, dec_p, tot_p)
    args.outf = os.path.join(
        args.outf, f"Encoder_{round(enc_p, 2)}M_Decoder_{round(dec_p, 2)}M"
                   f"_Total_{round(tot_p, 2)}M")
    return model


def load_pth(path: str, model) -> None:
    """Load a reference-layout stage-1 checkpoint (a torch state dict, as
    the reference and the JAX ``save_pth`` write it) into `model`. Keys the
    file lacks keep their values, as the JAX ``load_pth`` does."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=False)


def exp_id(args, cfg) -> str:
    return (f"{args.vid}_e{cfg['epoch']}_b{cfg['batch_size']}"
            f"_lr{cfg['learning_rate']}_{cfg['loss']}")


def split_dataset(args, dataset):
    args.final_size = dataset.final_size
    args.full_data_length = len(dataset)
    split = [int(x) for x in args.data_split.split("_")]
    train_ind, args.val_ind_list = data_split(
        list(range(args.full_data_length)), split, False, 0)
    return train_ind


def best_metrics_str(results, best=None):
    out, best = "", best or [0.0] * len(METRIC_NAMES)
    for i, (name, value) in enumerate(zip(METRIC_NAMES, results)):
        best[i] = max(best[i], float(np.max(value)))
        digits = 2 if "psnr" in name else 4
        out += f"best_{name}: {round(best[i], digits)} | "
    return out, best
