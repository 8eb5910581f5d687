"""Extremal Hessian eigenvalues of the reconstruction loss w.r.t. the
decoder's conv kernels (the counterpart of
``neuroquant_tpu/analysis/hessian_eigen.py``): scipy's ``eigsh`` on the host
around the port's Hessian-vector product
(``quantization.sensitivity.hessian_vector_product``, reverse-over-forward,
on the fused tail's kernels or the plain unpacked decode). Also exports the
per-layer Hessian-interaction matrix M[i, j] = v_i' H v_j for unit-norm
random directions v_k, one per layer (``--layer_matrix``); the directions
come from a ``torch.Generator``, not the JAX package's PRNG, so the matrix
is the same statistic over other directions.

Run (on the GPU; ``--device cpu`` for the CPU):
  python -m neuroquant_tpu_torch.analysis.hessian_eigen --config <yaml> \\
      --arch hnerv --ckpt <pth> --data_path <frames> [--layer_matrix]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np


def make_hvp(model, spec, frames, norm_idx, batch_idx):
    """(matvec(flat_v) -> flat_Hv, total_dim, unflatten, hvp, kernels): the
    spec layers' HWIO kernels flattened in layer order; hvp takes and
    returns a list of HWIO tensors. `norm_idx`: the frames' normalized
    indices, which NeRV encodes."""
    import torch

    from neuroquant_tpu_torch.quantization.qmodel import _get
    from neuroquant_tpu_torch.quantization.sensitivity import (
        hessian_vector_product)

    params = model.state_dict()
    kernels = [_get(params, pre)[0].detach() for pre in spec.layer_keys]
    shapes = [tuple(k.shape) for k in kernels]
    sizes = [int(np.prod(s)) for s in shapes]
    batches = [np.asarray(batch_idx)]

    def hvp(vs):
        return hessian_vector_product(model, spec, vs, frames, norm_idx,
                                      batches)

    def unflatten(flat):
        out, off = [], 0
        for shape, n in zip(shapes, sizes):
            out.append(torch.as_tensor(
                np.asarray(flat[off:off + n], np.float32).reshape(shape),
                device=frames.device))
            off += n
        return out

    def matvec(flat_v):
        hv = hvp(unflatten(np.asarray(flat_v, np.float32).ravel()))
        return np.concatenate([h.detach().cpu().numpy().ravel() for h in hv])

    return matvec, sum(sizes), unflatten, hvp, kernels


def extremal_eigenvalues(matvec, dim, k: int = 1, tol: float = 1e-2):
    """(max_eig, min_eig) via scipy eigsh on the implicit operator: the
    largest algebraic eigenvalue, then the smallest of LA on the shifted
    operator and SA (the JAX tool's strategy)."""
    from scipy.sparse.linalg import LinearOperator, eigsh

    op = LinearOperator((dim, dim), matvec=matvec, dtype=np.float32)
    max_eig = float(eigsh(op, k=k, which="LA", tol=tol,
                          return_eigenvectors=False)[0])
    shift = abs(max_eig)
    shifted = LinearOperator(
        (dim, dim), matvec=lambda v: matvec(v) - shift * np.asarray(v),
        dtype=np.float32)
    min_eig = float(eigsh(shifted, k=k, which="LA", tol=tol,
                          return_eigenvectors=False)[0]) + shift
    min_eig2 = float(eigsh(op, k=k, which="SA", tol=tol,
                           return_eigenvectors=False)[0])
    return max_eig, min(min_eig, min_eig2)


def main(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--arch", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--batch", default=4, type=int)
    parser.add_argument("--tol", default=1e-2, type=float)
    parser.add_argument("--layer_matrix", action="store_true",
                        help="also compute the per-layer v_i' H v_j matrix "
                             "(draw_hessian.ipynb heatmap)")
    parser.add_argument("--out", default="plots/hessian", type=str)
    parser.add_argument("--hvp_impl", default="auto", type=str,
                        choices=["auto", "pallas", "xla"],
                        help="HVP execution: the fused tail's CUDA kernels "
                             "(fused_tail pallas_hvp) or the plain unpacked "
                             "decode (off); 'auto' = pallas on the GPU, xla "
                             "on the CPU")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from neuroquant_tpu_torch.config import get_config
    from neuroquant_tpu_torch.data import VideoDataSet
    from neuroquant_tpu_torch.methods.common import load_pth
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.quantization.spec import make_spec
    from neuroquant_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.config)
    dataset = VideoDataSet(cfg, args.data_path, device=device)
    use_pallas = (args.hvp_impl == "pallas"
                  or (args.hvp_impl == "auto" and device.type == "cuda"))
    cfg["fused_tail"] = "pallas_hvp" if use_pallas else "off"
    model = build_model(args.arch, cfg, device=device)
    load_pth(args.ckpt, model)
    model.eval()
    spec = make_spec(args.arch, cfg)
    batch_idx = np.arange(min(args.batch, len(dataset)))

    # NeRV's cfg has no n_frames here, as in the JAX tool, so its encoding
    # is the plain fp32 formula
    matvec, dim, _, hvp, kernels = make_hvp(
        model, spec, dataset.frames, dataset.norm_idx, batch_idx)
    logging.info("Hessian dim: %d", dim)
    max_eig, min_eig = extremal_eigenvalues(matvec, dim, tol=args.tol)
    print(f"max_eig={max_eig:.6e} min_eig={min_eig:.6e} "
          f"ratio={abs(min_eig) / max(abs(max_eig), 1e-12):.4f}")

    if args.layer_matrix:
        n = len(kernels)
        gen = torch.Generator().manual_seed(0)
        vs = []
        for k in kernels:
            d = torch.randn(k.shape, generator=gen).to(device)
            vs.append(d / d.norm())
        m = np.zeros((n, n))
        for j in range(n):
            hv = hvp([vs[i] if i == j else torch.zeros_like(vs[i])
                      for i in range(n)])
            for i in range(n):
                m[i, j] = float((vs[i] * hv[i]).sum())
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        np.save(args.out + "_layer_matrix.npy", m)
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(5.5, 4.5))
        im = ax.imshow(np.log10(np.abs(m) + 1e-12), cmap="viridis")
        fig.colorbar(im, ax=ax, label="log10 |v_i' H v_j|")
        ax.set_title(f"layer-wise Hessian interaction ({args.arch})")
        fig.savefig(args.out + "_layer_matrix.png", dpi=130)
        plt.close(fig)
        logging.info("wrote %s_layer_matrix.png", args.out)
    return max_eig, min_eig


if __name__ == "__main__":
    main(sys.argv[1:])
