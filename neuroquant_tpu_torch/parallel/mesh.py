"""Data parallelism over frames on ``torch.distributed`` (the counterpart
of ``neuroquant_tpu/parallel/mesh.py``).

One process a rank. Every rank holds the whole model, optimizer state and
clip; each step's frame batch is split over the ranks on its leading axis
(:func:`shard_batch`), each rank takes its rows' loss normalised by the
global batch, and the gradients are summed over the ranks before the
optimizer (:func:`data_parallel_step`), so that every rank makes the
single-process update, up to the order of the sums. A batch norm inside
the step (PNeRV's shortcuts) takes its statistics over every rank's frames
(``models.layers.batch_over``), as over the whole batch in one process.
The JAX package runs one program over a device mesh and lets XLA insert
the sums; here the processes are spawned by :func:`launch`
(``--mesh_devices N`` of the CLIs), which joins them over gloo on the CPU
and NCCL on the card, rank r on ``cuda:r``.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from neuroquant_tpu_torch.models.layers import batch_over, norms_over_batch


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the data-parallel group."""
    rank: int
    size: int
    device: torch.device
    group: object

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that writes logs, checkpoints and artifacts."""
        return self.rank == 0


def is_main(mesh) -> bool:
    """True without a mesh, else on rank 0."""
    return mesh is None or mesh.is_main


def make_mesh(n: int, device) -> Mesh:
    """This rank's mesh over the initialised default process group of `n`
    ranks, on `device`."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (run the ranks "
                           "through launch or run_rank)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"make_mesh: the group has "
                           f"{dist.get_world_size()} ranks, not {n}")
    return Mesh(dist.get_rank(), n, torch.device(device), dist.group.WORLD)


def _flat(tensors):
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unflat_into(flat, tensors):
    off = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def replicate(tensors, mesh):
    """Broadcast `tensors` (a list) from rank 0 to every rank, in place
    (one broadcast of the concatenation of each dtype's; ``copy_`` bumps
    each tensor's version, so packed-weight caches see the change);
    returns them."""
    tensors = list(tensors)
    if mesh is not None:
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            group = [t for t in tensors if t.dtype == dtype]
            flat = _flat(group)
            dist.broadcast(flat, 0, group=mesh.group)
            _unflat_into(flat, group)
    return tensors


def shard_batch(x, mesh):
    """This rank's rows of the leading axis of `x`: the batch split into
    `mesh.size` contiguous parts whose sizes differ by at most one, the
    larger first (a batch smaller than the mesh leaves the last ranks
    none). Without a mesh, `x`."""
    if mesh is None:
        return x
    return torch.tensor_split(x, mesh.size)[mesh.rank]


def all_reduce_sum(t, mesh):
    """`t` summed over the ranks, in place (a loss or PSNR normalised by
    the global batch); returns it."""
    if mesh is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_reduce_grads(leaves, mesh) -> None:
    """Sum the leaves' gradients over the ranks (one all-reduce of their
    concatenation); a leaf without a gradient on this rank (a rank with no
    frame) contributes zeros."""
    if mesh is None:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in leaves]
    flat = _flat(grads)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    off = 0
    for p, g in zip(leaves, grads):
        n = g.numel()
        p.grad = flat[off:off + n].view_as(p).clone()
        off += n


def check_batch(model, batch_size: int, mesh) -> None:
    """Refuse a batch that leaves a rank no frame when `model` has a batch
    norm: its statistics are summed over the ranks, an all-reduce every
    rank must join, and a rank with no frame runs no forward."""
    if (mesh is not None and batch_size < mesh.size
            and norms_over_batch(model)):
        raise ValueError(
            f"batch {batch_size} over {mesh.size} ranks leaves a rank no "
            "frame, and this model's batch norm needs one on every rank: "
            "use a batch of at least --mesh_devices")


def data_parallel_step(step_fn, mesh, leaves):
    """``step(*args)``: ``step_fn(*args)`` (this rank's forward and
    backward, its loss normalised by the global batch; a batch norm inside
    takes the statistics of every rank's rows), then the leaves' gradients
    summed over the ranks (:func:`all_reduce_grads`), ready for the
    optimizer. Without a mesh, `step_fn` itself."""
    if mesh is None:
        return step_fn
    group = mesh.group if mesh.size > 1 else None

    def step(*args, **kw):
        with batch_over(group):
            out = step_fn(*args, **kw)
        all_reduce_grads(leaves, mesh)
        return out

    return step


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_cpu(obj):
    """A result made picklable across processes: tensors and modules to
    the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, torch.nn.Module):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def run_rank(rank: int, n: int, device, backend: str, init_method: str,
             fn, args=()):
    """One rank: set its device (before any kernel launch: the launchers
    take the current device's stream), join the group of `n` ranks, return
    ``fn(mesh, *args)``, and leave the group."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=n,
                            rank=rank)
    try:
        return fn(make_mesh(n, dev), *args)
    finally:
        dist.destroy_process_group()


def _rank_main(rank, devices, backend, port, fn, args, out_dir, threads):
    torch.set_num_threads(threads)
    result = run_rank(rank, len(devices), devices[rank], backend,
                      f"tcp://127.0.0.1:{port}", fn, args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(_to_cpu(result), f)


def launch(fn, n: int, device="cuda", args=(), devices=None):
    """Run ``fn(mesh, *args)`` on `n` spawned ranks and return their results
    in rank order (tensors and modules moved to the CPU). `device` 'cuda':
    rank r on ``cuda:r``, at most ``torch.cuda.device_count()`` ranks, the
    kernels built once here first; 'cpu': every rank on the CPU.
    `devices`, one a rank, places them instead (two ranks on one card, for
    a check on a one-card machine). The ranks join over NCCL when each has
    a card of its own, else over gloo. Any rank's failure fails the
    launch; it never runs on fewer ranks or on another device."""
    if devices is None:
        if torch.device(device).type == "cuda":
            have = torch.cuda.device_count()
            if n > have:
                raise RuntimeError(f"need {n} devices, have {have}")
            devices = [f"cuda:{r}" for r in range(n)]
        else:
            devices = ["cpu"] * n
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    on_cards = all(d.startswith("cuda") for d in devices)
    backend = ("nccl" if on_cards and len(set(devices)) == n else "gloo")
    if any(d.startswith("cuda") for d in devices):
        from neuroquant_tpu_torch.ops import _cuda
        _cuda.build()
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="nq_dp_") as out_dir:
        mp.spawn(_rank_main, nprocs=n, join=True,
                 args=(devices, backend, _free_port(), fn, tuple(args),
                       out_dir, torch.get_num_threads()))
        results = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
