"""Entropy coding of quantized weights -> bitstream + bpp (the port's own
copy of ``neuroquant_tpu/coding/codec.py``: numpy and ctypes, no torch).

Host-side stage 4, consuming the integer codes that calibrate_network
collects. A static-frequency arithmetic coder does the heavy lifting: a C++
implementation (native/range_coder.cpp, built on demand with g++ into the
package's ``_build`` directory and bound via ctypes). ``_py_encode`` and
``_py_decode`` are its bit-exact pure-Python mirror, the plain version that
tests call by name: at a real model's size (millions of symbols) they take
minutes, so nothing here falls back to them; a failed build raises.

For the same codes the stream is byte-identical to the JAX package's, and
each package decodes the other's.

Bitstream layout (little-endian):
  magic 'NQTB' | u8 version | u8 n_layers
  per layer:
    u8 bits | u32 n_w | u32 n_b | u16 n_sym
    u32 freqs_w[n_sym] | u32 len_w | bytes payload_w
    u32 freqs_b[n_sym] | u32 len_b | bytes payload_b
    f16 scale/zero-point block (per-channel deltas + zps + bias delta/zp)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from functools import lru_cache

import numpy as np

_TOTAL_FREQ = 1 << 16
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "range_coder.cpp")
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


# --------------------------------------------------------------------------
# Native library build + binding.
# --------------------------------------------------------------------------
def build_native() -> str:
    """Compile the range coder if this source has no library yet; returns
    the library's path under ``neuroquant_tpu_torch/_build/``. Raises with
    the compiler's output when the build fails."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + f.read())
    out_dir = os.path.join(_PKG, "_build", "coder-" + digest.hexdigest()[:16])
    so_path = os.path.join(out_dir, "librange_coder.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = os.path.join(out_dir, f"tmp{os.getpid()}.so")
    try:
        r = subprocess.run(["g++", *_CXX_FLAGS, _SRC, "-o", tmp],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found; the range coder cannot be "
                           "built") from e
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC}:\n{r.stdout}")
    os.replace(tmp, so_path)
    return so_path


@lru_cache(maxsize=1)
def _native_lib():
    lib = ctypes.CDLL(build_native())
    lib.rc_encode.restype = ctypes.c_longlong
    lib.rc_encode.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong]
    lib.rc_decode.restype = ctypes.c_longlong
    lib.rc_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong]
    return lib


# --------------------------------------------------------------------------
# Pure-Python coder (bit-exact mirror of range_coder.cpp).
# --------------------------------------------------------------------------
_TOP, _HALF, _QUARTER, _THREEQ = 0xFFFFFFFF, 0x80000000, 0x40000000, 0xC0000000


def _py_encode(symbols, freqs):
    cum = np.zeros(len(freqs) + 1, np.uint64)
    cum[1:] = np.cumsum(freqs)
    total = int(cum[-1])
    if not 0 < total <= _TOTAL_FREQ:
        raise ValueError(f"frequency total {total} outside (0, "
                         f"{_TOTAL_FREQ}]")
    bits = []
    low, high, pending = 0, _TOP, 0

    def emit(bit):
        nonlocal pending
        bits.append(bit)
        while pending:
            bits.append(1 - bit)
            pending -= 1

    for s in symbols:
        span = high - low + 1
        high = low + span * int(cum[s + 1]) // total - 1
        low = low + span * int(cum[s]) // total
        while True:
            if high < _HALF:
                emit(0)
            elif low >= _HALF:
                emit(1)
                low -= _HALF
                high -= _HALF
            elif low >= _QUARTER and high < _THREEQ:
                pending += 1
                low -= _QUARTER
                high -= _QUARTER
            else:
                break
            low = (low << 1) & _TOP
            high = ((high << 1) | 1) & _TOP
    pending += 1
    emit(0 if low < _QUARTER else 1)
    out = np.zeros((len(bits) + 7) // 8, np.uint8)
    for i, b in enumerate(bits):
        if b:
            out[i >> 3] |= 1 << (7 - (i & 7))
    return out.tobytes()


def _py_decode(data, freqs, n):
    cum = np.zeros(len(freqs) + 1, np.uint64)
    cum[1:] = np.cumsum(freqs)
    total = int(cum[-1])
    arr = np.frombuffer(data, np.uint8)
    nbits = len(arr) * 8

    pos = 0

    def get():
        nonlocal pos
        if pos >= nbits:
            pos += 1
            return 0
        b = (arr[pos >> 3] >> (7 - (pos & 7))) & 1
        pos += 1
        return int(b)

    low, high, value = 0, _TOP, 0
    for _ in range(32):
        value = ((value << 1) | get()) & _TOP
    out = np.empty(n, np.int32)
    cum_list = cum.astype(np.int64)
    for k in range(n):
        span = high - low + 1
        scaled = ((value - low + 1) * total - 1) // span
        s = int(np.searchsorted(cum_list, scaled, side="right")) - 1
        out[k] = s
        high = low + span * int(cum[s + 1]) // total - 1
        low = low + span * int(cum[s]) // total
        while True:
            if high < _HALF:
                pass
            elif low >= _HALF:
                low -= _HALF
                high -= _HALF
                value -= _HALF
            elif low >= _QUARTER and high < _THREEQ:
                low -= _QUARTER
                high -= _QUARTER
                value -= _QUARTER
            else:
                break
            low = (low << 1) & _TOP
            high = ((high << 1) | 1) & _TOP
            value = ((value << 1) | get()) & _TOP
    return out


# --------------------------------------------------------------------------
# Public symbol-level API.
# --------------------------------------------------------------------------
def build_freqs(symbols: np.ndarray, n_sym: int) -> np.ndarray:
    """Histogram scaled so sum <= 1<<16 with every present symbol >= 1."""
    hist = np.bincount(symbols.ravel(), minlength=n_sym).astype(np.float64)
    present = hist > 0
    scale = (_TOTAL_FREQ - present.sum()) / max(hist.sum(), 1)
    freqs = np.floor(hist * scale).astype(np.uint32)
    freqs[present] = np.maximum(freqs[present], 1)
    return freqs


def encode_symbols(symbols: np.ndarray, freqs: np.ndarray) -> bytes:
    symbols = np.ascontiguousarray(symbols.ravel(), np.int32)
    freqs = np.ascontiguousarray(freqs, np.uint32)
    lib = _native_lib()
    cap = symbols.size * 4 + 1024
    out = np.zeros(cap, np.uint8)
    n = lib.rc_encode(
        symbols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), symbols.size,
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(freqs),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n <= 0:
        raise RuntimeError(f"rc_encode failed: {n}")
    return out[:n].tobytes()


def decode_symbols(data: bytes, freqs: np.ndarray, n: int) -> np.ndarray:
    freqs = np.ascontiguousarray(freqs, np.uint32)
    lib = _native_lib()
    arr = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.int32)
    r = lib.rc_decode(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size,
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(freqs),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
    if r != n:
        raise RuntimeError(f"rc_decode failed: {r}")
    return out


def encode_symbols_per_column(sym2d: np.ndarray, n_sym: int):
    """Per-column coding of (N, C) symbols: one frequency table + payload per
    column. In the Hadamard domain, columns (C_in positions) have wildly
    different energies — the DC column carries most of the signal — so
    per-column models beat one per-layer table by ~10-20%.

    Returns (freqs (C, n_sym) uint32, payloads list[bytes]).
    """
    n, c = sym2d.shape
    freqs = np.zeros((c, n_sym), np.uint32)
    payloads = []
    for j in range(c):
        col = np.ascontiguousarray(sym2d[:, j])
        f = build_freqs(col, n_sym)
        freqs[j] = f
        payloads.append(encode_symbols(col, f))
    return freqs, payloads


def decode_symbols_per_column(payloads, freqs: np.ndarray, n: int):
    cols = [decode_symbols(p, freqs[j], n) for j, p in enumerate(payloads)]
    return np.stack(cols, axis=1)


# --------------------------------------------------------------------------
# Artifact-level API: calibrated model -> bitstream -> reconstructed codes.
# --------------------------------------------------------------------------
def compress_artifact(int_codes: dict) -> bytes:
    """Serialize the per-layer integer codes (+ scales) from
    collect_int_codes into one bitstream (format v2).

    4-D weight codes are coded per C_in column when that is smaller than one
    per-layer model (it usually is in the Hadamard domain); the smaller of
    the two encodings is chosen per layer."""
    blobs = [b"NQTB", struct.pack("<BB", 2, len(int_codes))]
    for name, c in int_codes.items():
        w = np.asarray(c["w"], np.int32)
        b = np.asarray(c["b"], np.int32)
        bits = int(c["bits"])
        n_sym = 1 << bits

        # candidate 0: one per-layer model
        fw = build_freqs(w, n_sym)
        pw = encode_symbols(w, fw)
        size0 = len(pw) + 4 * n_sym
        # candidate 1: per-C_in-column models (4-D weights only)
        wmode, grouped = 0, None
        if w.ndim == 4:
            cdim = w.shape[2]
            w2 = np.ascontiguousarray(
                w.transpose(0, 1, 3, 2).reshape(-1, cdim))
            gf, gp = encode_symbols_per_column(w2, n_sym)
            size1 = sum(len(p) for p in gp) + 4 * n_sym * cdim + 4 * cdim
            if size1 < size0:
                wmode, grouped = 1, (gf, gp, w2.shape[0])

        fb = build_freqs(b, n_sym)
        pb = encode_symbols(b, fb)
        scales = np.concatenate([
            np.asarray(c["w_delta"], np.float32).ravel(),
            np.asarray(c["w_zp"], np.float32).ravel(),
            np.asarray(c["b_delta"], np.float32).ravel(),
            np.asarray(c["b_zp"], np.float32).ravel(),
        ]).astype(np.float16)
        name_b = name.encode()
        blobs.append(struct.pack("<H", len(name_b)) + name_b)
        blobs.append(struct.pack("<BIIH", bits, w.size, b.size, n_sym))
        blobs.append(struct.pack("<B", len(w.shape)))
        blobs.append(np.asarray(w.shape, np.uint32).tobytes())
        blobs.append(struct.pack("<B", wmode))
        if wmode == 0:
            blobs.append(fw.tobytes())
            blobs.append(struct.pack("<I", len(pw)) + pw)
        else:
            gf, gp, _ = grouped
            blobs.append(struct.pack("<H", gf.shape[0]))
            blobs.append(gf.tobytes())
            for p in gp:
                blobs.append(struct.pack("<I", len(p)) + p)
        blobs.append(fb.tobytes())
        blobs.append(struct.pack("<I", len(pb)) + pb)
        blobs.append(struct.pack("<I", scales.size) + scales.tobytes())
    return b"".join(blobs)


def decompress_artifact(stream: bytes) -> dict:
    """Inverse of compress_artifact: bitstream -> {name: {w, b, bits, scales}}.
    Reads format v1 (per-layer models) and v2 (optional per-column models)."""
    if stream[:4] != b"NQTB":
        raise ValueError("not an NQTB stream")
    version, n_layers = struct.unpack_from("<BB", stream, 4)
    if version not in (1, 2):
        raise ValueError(f"NQTB version {version} not supported")
    off = 6
    out = {}
    for _ in range(n_layers):
        (nlen,) = struct.unpack_from("<H", stream, off); off += 2
        name = stream[off:off + nlen].decode(); off += nlen
        bits, n_w, n_b, n_sym = struct.unpack_from("<BIIH", stream, off); off += 11
        (ndim,) = struct.unpack_from("<B", stream, off); off += 1
        shape = tuple(np.frombuffer(stream, np.uint32, ndim, off).tolist())
        off += 4 * ndim
        wmode = 0
        if version >= 2:
            (wmode,) = struct.unpack_from("<B", stream, off); off += 1
        if wmode == 0:
            fw = np.frombuffer(stream, np.uint32, n_sym, off).copy(); off += 4 * n_sym
            (lw,) = struct.unpack_from("<I", stream, off); off += 4
            pw = stream[off:off + lw]; off += lw
            w = decode_symbols(pw, fw, n_w).reshape(shape)
        else:
            (cdim,) = struct.unpack_from("<H", stream, off); off += 2
            gf = np.frombuffer(stream, np.uint32, n_sym * cdim, off).reshape(
                cdim, n_sym).copy(); off += 4 * n_sym * cdim
            payloads = []
            for _j in range(cdim):
                (lw,) = struct.unpack_from("<I", stream, off); off += 4
                payloads.append(stream[off:off + lw]); off += lw
            n_rows = n_w // cdim
            w2 = decode_symbols_per_column(payloads, gf, n_rows)
            kh, kw, c, cout = shape
            w = w2.reshape(kh, kw, cout, c).transpose(0, 1, 3, 2)
        fb = np.frombuffer(stream, np.uint32, n_sym, off).copy(); off += 4 * n_sym
        (lb,) = struct.unpack_from("<I", stream, off); off += 4
        pb = stream[off:off + lb]; off += lb
        (ns,) = struct.unpack_from("<I", stream, off); off += 4
        scales = np.frombuffer(stream, np.float16, ns, off).copy(); off += 2 * ns
        out[name] = {
            "bits": bits,
            "w": w,
            "b": decode_symbols(pb, fb, n_b),
            "scales": scales.astype(np.float32),
        }
    return out
