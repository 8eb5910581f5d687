"""Build and load the CUDA kernels in ``neuroquant_tpu_torch/csrc``.

At first use every ``csrc/*.cu`` compiles with its own ``nvcc`` process,
all started together, for ``sm_90a``; the objects link into one shared
library with a plain C interface, loaded with ctypes. The library lands in
``neuroquant_tpu_torch/_build/<hash>/``, keyed on a hash of the sources and
flags, so a changed source rebuilds and an unchanged one loads at once.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libnq_kernels.so"

# filled by build(): wall seconds and nvcc's messages (ptxas register and
# spill counts) of the last build in this process, None when it was cached
BUILD_INFO = {"seconds": None, "log": ""}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built")


def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def build() -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library's path. Raises with nvcc's output when a build fails."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    t0 = time.time()
    tmp = os.path.join(out_dir, f"tmp{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    nvcc = _nvcc()
    cus = [p for p in sources() if p.endswith(".cu")]
    procs = []
    for src in cus:
        obj = os.path.join(tmp, os.path.basename(src) + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {os.path.basename(src)}\n{out}")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
    tmp_lib = os.path.join(tmp, LIB_NAME)
    link = subprocess.run([nvcc, "-shared", "-o", tmp_lib,
                           *(obj for _, obj, _ in procs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(seconds=time.time() - t0, log="\n".join(log))
    return lib_path


@lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded kernel library with its C signatures declared."""
    so = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {
        # x, w, bias|NULL, out_mul|NULL, mask, ksteps, out_z|NULL,
        # out_y|NULL, part|NULL, B, cin, cout, mp, nsteps, splits, act_in,
        # stream
        "nq_tail_conv_cf": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                            p],
        # the same arguments, bf16 x, w, bias, out_mul, out_z, out_y
        "nq_tail_conv_cf_bf16": [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                 i, i, p],
        # x, g, ksteps, part, out, B, cin, cout, mp, nsteps, splits, chunk,
        # act_in, stream
        "nq_tail_conv_dw_cf": [p, p, p, p, p, i, i, i, i, i, i, i, i, p],
        # the same arguments, bf16 x and g
        "nq_tail_conv_dw_cf_bf16": [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                    p],
        # cout, int[4] / int[3]: the TMA launchers' tile, stages and shared
        # memory (ops/tail_fused.conv_f32_geometry, conv_bf16_geometry,
        # dw_bf16_geometry)
        "nq_tail_conv_cf_tile": [i, p],
        "nq_tail_conv_cf_bf16_tile": [i, p],
        "nq_tail_conv_dw_cf_bf16_tile": [i, p],
        # x, out, parameter block (B, h, w, c, c8, pad, mp, tm, in type,
        # out type, shared bytes), stream
        "nq_pack_cf": [p, p, p, p],
        # g, out, parameter block (B, h, w, c, c8, pad, mp, tq, in type,
        # out type; from bf16, shared bytes), stream
        "nq_unpack_cf": [p, p, p, p],
        # z, out, parameter block (B, cp, mp, h, w, pad, f, c, mode, tx,
        # fu, in type, out type, the offset's bits, shared bytes), stream
        "nq_unpack_frames": [p, p, p, p],
        # the group's descriptor (ops/fused_fakequant._Group), stream
        "nq_fq_group_forward": [p, p],
        "nq_fq_group_backward": [p, p],
        # the Group's size and the threads a block, for the mirror's checks
        "nq_fq_group_bytes": [],
        "nq_fq_threads": [],
    }
    for name, args in sigs.items():
        fn = getattr(so, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    so.nq_error_string.argtypes = [ctypes.c_int]
    so.nq_error_string.restype = ctypes.c_char_p
    return so


def error_string(code: int) -> str:
    return lib().nq_error_string(int(code)).decode()
