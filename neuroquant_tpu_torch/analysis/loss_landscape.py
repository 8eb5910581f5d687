"""Loss-landscape surfaces, lines and trajectories around a trained
(optionally one-layer-quantized) decoder (the counterpart of
``neuroquant_tpu/analysis/loss_landscape.py``): filter-normalized random
directions, optional symmetric quantization of one chosen layer, the MSE
over an (alpha, beta) grid, the same ``.h5`` files and dataset names, a
contour plot, a ParaView ``.vtp``.

The JAX package vmaps a chunk of perturbed decoders into one program. The
port's kernels have no batching rule over weights, so each grid point is
one decode on the kernels with the point's weights set in place
(``copy_`` under ``no_grad``, which bumps each parameter's version: the
decoder's kept packed weights are rebuilt for every point); a ``--chunk``
of points shares one host fetch of their losses. The directions come from
a ``torch.Generator`` on `seed`, not the JAX PRNG: a caller that wants the
JAX package's passes them in (``dirs``).

Run (on the GPU; ``--device cpu`` for the CPU):
  python -m neuroquant_tpu_torch.analysis.loss_landscape --config <yaml> \\
      --arch hnerv --ckpt <epoch300.pth> --data_path <frames> \\
      --x=-1:1:21 --y=-1:1:21 [--lid 3 --b_w 4]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch


def parse_range(spec: str):
    lo, hi, num = spec.split(":")
    return float(lo), float(hi), int(num)


def filter_normalized_direction(generator, kernels):
    """A random direction per HWIO kernel with each filter's norm matched
    to the weights' (d_filter *= ||w_filter|| / ||d_filter||); a filter is
    one output channel (the last axis); a 1-D leaf gets a zero direction.
    Drawn from the CPU `generator`, in the kernels' dtype and device."""
    dirs = []
    for w in kernels:
        d = torch.randn(tuple(w.shape), generator=generator,
                        dtype=w.dtype).to(w.device)
        if w.dim() <= 1:
            dirs.append(torch.zeros_like(w))
            continue
        flat_w = w.reshape(-1, w.shape[-1])
        flat_d = d.reshape(-1, w.shape[-1])
        norm_w = torch.linalg.vector_norm(flat_w, dim=0)
        norm_d = torch.linalg.vector_norm(flat_d, dim=0) + 1e-10
        dirs.append((flat_d * (norm_w / norm_d)).reshape(w.shape))
    return dirs


def symmetric_quantize_layer(w, n_bits: int):
    """Simple symmetric round of one layer (plot_hnerv_surface.py:149-168)."""
    scale = w.abs().max() / (2 ** (n_bits - 1) - 1)
    return torch.round(w / scale) * scale


def _hwio(w):
    return w.permute(2, 3, 1, 0)


class _Perturbed:
    """The model's quantized conv kernels set to ``w + sum_i c_i d_i``,
    one grid point at a time, in place; the centre restored on exit."""

    def __init__(self, model, keys, centre):
        named = dict(model.named_parameters())
        self.params = [named[k] for k in keys]
        self.centre = centre           # HWIO, one per key

    def set(self, coeffs, dirs):
        with torch.no_grad():
            for i, (p, w) in enumerate(zip(self.params, self.centre)):
                v = w
                for c, d in zip(coeffs, dirs):
                    v = v + c * d[i]
                p.copy_(v.permute(3, 2, 0, 1))

    def __enter__(self):
        self.saved = [p.detach().clone() for p in self.params]
        return self

    def __exit__(self, *exc):
        with torch.no_grad():
            for p, s in zip(self.params, self.saved):
                p.copy_(s)


def _on(dirs, like):
    """Directions given as arrays or tensors, on the kernels' device and
    dtype."""
    return [(d.detach() if torch.is_tensor(d) else torch.tensor(np.array(d)))
            .to(dtype=w.dtype, device=w.device) for d, w in zip(dirs, like)]


def _centre(model, keys, lid: int, b_w: int):
    """The HWIO kernels of the centre: the model's, with layer `lid`
    symmetrically quantized to `b_w` bits when both are set (before the
    directions are drawn, as the reference)."""
    named = dict(model.named_parameters())
    kernels = [_hwio(named[k].detach()).clone() for k in keys]
    if lid >= 0 and b_w > 0:
        kernels[lid] = symmetric_quantize_layer(kernels[lid], b_w)
    return kernels


@torch.no_grad()
def _losses(model, keys, centre, dirs, coords, emb, img, chunk: int,
            what: str):
    """MSE of the decode at each row of `coords` (coefficients of `dirs`),
    one decode a point, the losses of a chunk fetched together."""
    out = []
    with _Perturbed(model, keys, centre) as pert:
        for s in range(0, len(coords), chunk):
            part = []
            for c in coords[s:s + chunk]:
                pert.set([float(v) for v in c], dirs)
                part.append(torch.mean((model.decode(emb) - img) ** 2))
            out.extend(torch.stack(part).double().cpu().numpy().tolist())
            logging.info("%s: %d/%d points", what, min(s + chunk, len(coords)),
                         len(coords))
    return np.asarray(out)


def _batch(model, frames, norm_idx, batch_idx):
    """(the frames of the loss batch, their embeddings)."""
    idx = torch.as_tensor(np.asarray(batch_idx, np.int64),
                          device=frames.device)
    img = frames[idx]
    with torch.no_grad():
        emb = model.encode(model.model_input(frames, norm_idx)[idx])
    return img, emb


def compute_surface(model, keys, frames, norm_idx, xs, ys, batch_idx,
                    chunk: int = 8, lid: int = -1, b_w: int = 0,
                    seed: int = 123, dirs=None):
    """The (len(xs), len(ys)) loss surface around the model's weights
    along two filter-normalized directions of the kernels named `keys`
    (OIHW parameters; the directions are HWIO tensors, one per key), or
    along `dirs` = (d1, d2). The model's weights are as before on
    return."""
    centre = _centre(model, keys, lid, b_w)
    if dirs is not None:
        d1, d2 = (_on(ds, centre) for ds in dirs)
    else:
        gen = torch.Generator().manual_seed(seed)
        d1 = filter_normalized_direction(gen, centre)
        d2 = filter_normalized_direction(gen, centre)
    img, emb = _batch(model, frames, norm_idx, batch_idx)
    coords = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    losses = _losses(model, keys, centre, (d1, d2), coords, emb, img, chunk,
                     "surface")
    return losses.reshape(len(xs), len(ys))


def compute_line(model, keys, frames, norm_idx, xs, batch_idx,
                 chunk: int = 8, lid: int = -1, b_w: int = 0,
                 seed: int = 123, dirs=None):
    """1-D loss and PSNR along one filter-normalized direction (or `dirs`,
    one HWIO tensor per key): (losses, PSNR), the reference fork's
    plot_1D.py line with PSNR as the accuracy axis."""
    centre = _centre(model, keys, lid, b_w)
    if dirs is not None:
        d1 = _on(dirs, centre)
    else:
        d1 = filter_normalized_direction(
            torch.Generator().manual_seed(seed), centre)
    img, emb = _batch(model, frames, norm_idx, batch_idx)
    coords = np.asarray(xs, np.float64).reshape(-1, 1)
    losses = _losses(model, keys, centre, (d1,), coords, emb, img, chunk,
                     "line")
    psnr = -10.0 * np.log10(losses + 1e-9)
    return losses, psnr


def flatten_dirlist(dirs):
    return np.concatenate([np.asarray(d).reshape(-1) for d in dirs])


def _snapshot_kernels(path, keys):
    """The HWIO kernels `keys` of a stage-1 .pth (a reference-layout state
    dict), as numpy."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return [_hwio(sd[k]).numpy() for k in keys]


def pca_directions(ckpt_files, final_kernels, keys):
    """PCA(2) of the optimization path w_i - w_final over the decoder's
    conv kernels (HWIO numpy; biases ignored, the reference's 'biasbn'
    mode): (d1 list, d2 list, explained variance ratio of the two)."""
    mat = []
    for f in ckpt_files:
        ks = _snapshot_kernels(f, keys)
        mat.append(flatten_dirlist([k - np.asarray(w)
                                    for k, w in zip(ks, final_kernels)]))
    mat = np.stack(mat)                      # (n_ckpts, n_params)
    mat = mat - mat.mean(axis=0, keepdims=True)
    _, svals, vt = np.linalg.svd(mat, full_matrices=False)
    var = svals ** 2
    evr = var / var.sum()
    pc1, pc2 = vt[0], vt[1]

    def unflatten(vec):
        out, off = [], 0
        for w in final_kernels:
            n = int(np.prod(np.asarray(w).shape))
            out.append(vec[off:off + n].reshape(np.asarray(w).shape)
                       .astype(np.float32))
            off += n
        return out

    return unflatten(pc1), unflatten(pc2), evr[:2]


def project_trajectory(ckpt_files, final_kernels, d1, d2, keys):
    """Cosine projection of each snapshot's (w_i - w_final) onto the two
    directions (projection.py project_2D 'cos')."""
    fx = flatten_dirlist(d1)
    fy = flatten_dirlist(d2)
    xs, ys = [], []
    for f in ckpt_files:
        ks = _snapshot_kernels(f, keys)
        d = flatten_dirlist([k - np.asarray(w)
                             for k, w in zip(ks, final_kernels)])
        xs.append(float(np.dot(d, fx) / (np.linalg.norm(fx) + 1e-12)))
        ys.append(float(np.dot(d, fy) / (np.linalg.norm(fy) + 1e-12)))
    return np.asarray(xs), np.asarray(ys)


def export_vtp(xs, ys, surface, out_path, log: bool = False,
               zmax: float = -1.0):
    """Write the surface as a ParaView-readable vtkPolyData .vtp (XML): grid
    points at (x, y, z=loss) with a 'zvalue' point-data array and quad cells
    (the reference fork's h52vtp.py output)."""
    z = np.asarray(surface, np.float64).copy()
    if zmax > 0:
        z = np.minimum(z, zmax)
    if log:
        z = np.log(z + 0.1)
    nx, ny = len(xs), len(ys)
    xx, yy = np.meshgrid(np.asarray(xs), np.asarray(ys), indexing="ij")
    pts = np.stack([xx.reshape(-1), yy.reshape(-1), z.reshape(-1)], -1)
    n_pts = nx * ny

    quads = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            quads.append((a, a + 1, a + ny + 1, a + ny))
    quads = np.asarray(quads, np.int64)

    def arr(name, data, ncomp, dtype="Float32"):
        flat = np.asarray(data).reshape(-1)
        body = "\n".join(" ".join(str(v) for v in flat[k:k + 9])
                         for k in range(0, len(flat), 9))
        return (f'<DataArray type="{dtype}" Name="{name}" '
                f'NumberOfComponents="{ncomp}" format="ascii" '
                f'RangeMin="{flat.min()}" RangeMax="{flat.max()}">\n'
                f"{body}\n</DataArray>\n")

    with open(out_path, "w") as f:
        f.write('<VTKFile type="PolyData" version="1.0" '
                'byte_order="LittleEndian" header_type="UInt64">\n'
                "<PolyData>\n"
                f'<Piece NumberOfPoints="{n_pts}" NumberOfVerts="0" '
                'NumberOfLines="0" NumberOfStrips="0" '
                f'NumberOfPolys="{len(quads)}">\n')
        f.write('<PointData Scalars="zvalue">\n')
        f.write(arr("zvalue", pts[:, 2], 1))
        f.write("</PointData>\n<Points>\n")
        f.write(arr("Points", pts, 3))
        f.write("</Points>\n<Polys>\n")
        f.write(arr("connectivity", quads, 1, "Int64"))
        offsets = np.arange(1, len(quads) + 1, dtype=np.int64) * 4
        f.write(arr("offsets", offsets, 1, "Int64"))
        f.write("</Polys>\n</Piece>\n</PolyData>\n</VTKFile>\n")
    logging.info("wrote %s (%d points, %d quads)", out_path, n_pts, len(quads))
    return out_path


def _plot_line(out, xs, losses, psnr, arch, lid, b_w):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax1 = plt.subplots(figsize=(6, 4))
    ax2 = ax1.twinx()
    ax1.semilogy(xs, losses, "b-", label="Training loss")
    ax2.plot(xs, psnr, "r-", label="PSNR (dB)")
    ax1.set_xlabel("alpha")
    ax1.set_ylabel("Loss", color="b")
    ax2.set_ylabel("PSNR (dB)", color="r")
    ax1.set_title(f"1-D loss line ({arch}, lid={lid}, b_w={b_w})")
    fig.savefig(out + "_1d.png", dpi=130, bbox_inches="tight")
    plt.close(fig)


def _plot_surface(out, xs, ys, surface, traj, arch, lid, b_w):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    cs = ax.contour(xs, ys, surface.T, levels=15)
    ax.clabel(cs, inline=True, fontsize=7)
    if traj is not None:
        ax.plot(traj[0], traj[1], marker=".", color="r", linewidth=1,
                label="optimization path")
        ax.legend(fontsize=8)
    ax.set_title(f"loss surface ({arch}, lid={lid}, b_w={b_w})")
    fig.savefig(out + ".png", dpi=130)
    plt.close(fig)


def main(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--arch", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--mode", default="surface", type=str,
                        choices=["surface", "line", "trajectory"],
                        help="2-D surface (plot_surface), 1-D loss/PSNR line "
                             "(plot_1D), or PCA trajectory over snapshots "
                             "(projection.py)")
    parser.add_argument("--ckpt_glob", default="", type=str,
                        help="trajectory mode: glob of snapshot .pth files "
                             "in training order (regress --snapshot_freq)")
    parser.add_argument("--x", default="-1:1:11", type=str)
    parser.add_argument("--y", default="-1:1:11", type=str)
    parser.add_argument("--lid", default=-1, type=int,
                        help="layer index to pre-quantize (-1: none)")
    parser.add_argument("--b_w", default=0, type=int, help="bits for --lid")
    parser.add_argument("--batch", default=4, type=int,
                        help="frames in the loss batch")
    parser.add_argument("--chunk", default=8, type=int,
                        help="grid points whose losses are fetched together "
                             "(one decode a point)")
    parser.add_argument("--out", default="plots/surface", type=str)
    parser.add_argument("--export_vtp", action="store_true", default=False,
                        help="also write a ParaView .vtp of the surface "
                             "(the fork's h52vtp.py)")
    parser.add_argument("--vtp_log", action="store_true", default=False)
    parser.add_argument("--vtp_zmax", default=-1.0, type=float)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import glob as globmod

    import h5py

    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.data import VideoDataSet
    from neuroquant_tpu_torch.methods.common import load_pth
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.quantization.spec import make_spec
    from neuroquant_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = validate_config(get_config(args.config), args.arch)
    dataset = VideoDataSet(cfg, args.data_path, device=device)
    model = build_model(args.arch, cfg, device=device)
    load_pth(args.ckpt, model)
    model.eval()
    keys = [f"{pre}.weight" for pre in make_spec(args.arch, cfg).layer_keys]

    x0, x1, xn = parse_range(args.x)
    y0, y1, yn = parse_range(args.y)
    xs, ys = np.linspace(x0, x1, xn), np.linspace(y0, y1, yn)
    batch_idx = np.arange(min(args.batch, len(dataset)))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    if args.mode == "line":
        losses, psnr = compute_line(
            model, keys, dataset.frames, dataset.norm_idx, xs, batch_idx,
            chunk=args.chunk, lid=args.lid, b_w=args.b_w)
        with h5py.File(args.out + "_1d.h5", "w") as f:
            f["xcoordinates"] = xs
            f["train_loss"] = losses
            f["train_psnr"] = psnr     # the accuracy axis of plot_1D.py
        _plot_line(args.out, xs, losses, psnr, args.arch, args.lid, args.b_w)
        logging.info("wrote %s_1d.{h5,png}", args.out)
        return losses

    dirs = traj = None
    if args.mode == "trajectory":
        files = sorted(globmod.glob(args.ckpt_glob))
        assert len(files) >= 3, (f"trajectory mode needs >=3 snapshots, got "
                                 f"{len(files)} from {args.ckpt_glob!r}")
        final = [k.cpu().numpy() for k in _centre(model, keys, -1, 0)]
        d1, d2, evr = pca_directions(files, final, keys)
        logging.info("PCA explained variance: %.1f%% / %.1f%%",
                     100 * evr[0], 100 * evr[1])
        px, py = project_trajectory(files, final, d1, d2, keys)
        with h5py.File(args.out + "_dirs.h5", "w") as f:
            for i, d in enumerate(d1):
                f[f"xdirection/{i}"] = d
            for i, d in enumerate(d2):
                f[f"ydirection/{i}"] = d
            f["explained_variance_ratio_"] = evr
        with h5py.File(args.out + "_proj_cos.h5", "w") as f:
            f["proj_xcoord"] = px
            f["proj_ycoord"] = py
        # widen the grid to cover the trajectory (net_plotter convention)
        xs = np.linspace(min(x0, px.min() * 1.1), max(x1, px.max() * 1.1), xn)
        ys = np.linspace(min(y0, py.min() * 1.1), max(y1, py.max() * 1.1), yn)
        dirs, traj = (d1, d2), (px, py)

    surface = compute_surface(model, keys, dataset.frames, dataset.norm_idx,
                              xs, ys, batch_idx, chunk=args.chunk,
                              lid=args.lid, b_w=args.b_w, dirs=dirs)
    with h5py.File(args.out + ".h5", "w") as f:    # the tool's keys
        f["xcoordinates"] = xs
        f["ycoordinates"] = ys
        f["train_loss"] = surface
    logging.info("wrote %s.h5", args.out)
    if args.export_vtp:
        export_vtp(xs, ys, surface, args.out + ".vtp", log=args.vtp_log,
                   zmax=args.vtp_zmax)
    if len(xs) >= 2 and len(ys) >= 2:
        _plot_surface(args.out, xs, ys, surface, traj, args.arch, args.lid,
                      args.b_w)
        logging.info("wrote %s.png", args.out)
    return surface


if __name__ == "__main__":
    main(sys.argv[1:])
