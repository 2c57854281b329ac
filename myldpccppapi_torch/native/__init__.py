"""The port's native host library: bit-packed GF(2) kernels and the C++
golden decoders, loaded with :mod:`ctypes`.

Counterpart of ``myldpccppapi_tpu/native`` with the same public functions,
taking the port's code objects (:class:`~..codes.qc.QCCode`,
:class:`~..codes.rs_ldpc.RSLDPCCode`, anything with ``h_coo``).  The sources
beside this file are copies of the reference's (``gf2kernels.cpp``,
``golden_decoder.cpp``); :func:`build` compiles them with ``g++`` at first
use, never at import, into ``myldpccppapi_torch/_build/`` (git-ignored),
named by a hash of the sources and the flags.  The flags are the reference
Makefile's plus an explicit ``-ffp-contract=off``, so the goldens compute
what the reference's library computes, bit for bit.

There is no fallback: a missing compiler or a failed build raises
``RuntimeError`` with the compiler's output.  The plain versions of these
functions are the NumPy bodies of :mod:`..codes.gf2` and
:mod:`..ops.golden`, which the tests hold the library against.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
import weakref

import numpy as np

__all__ = ["build", "load", "find_cxx", "pack_bits", "unpack_bits",
           "rref_packed", "inv_packed", "matmul_packed", "pack_rows",
           "unpack_rows", "decode_golden_native", "decode_golden_layered_native",
           "decode_golden_flooding_native", "decode_golden_sp_ref_native"]

_DIR = pathlib.Path(__file__).resolve().parent
_BUILD = _DIR.parent / "_build"
#: the library's sources, beside this file
SOURCES = ("gf2kernels.cpp", "golden_decoder.cpp")
#: the reference Makefile's flags; GCC leaves multiply-adds uncontracted in
#: ISO mode already, the flag says so explicitly
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared",
             "-ffp-contract=off")

_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64, _i32, _f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
#: name -> (argtypes, restype) of every exported function
_SIGNATURES = {
    "pack_bits_lsb": ([_U8, _U8, _i64], None),
    "unpack_bits_lsb": ([_U8, _U8, _i64], None),
    "gf2_rref_packed": ([_U64, _i64, _i64, _i64, _I64], _i64),
    "gf2_inv_packed": ([_U64, _U64, _i64, _i64], _i64),
    "gf2_matmul_packed": ([_U64, _U64, _U64, _i64, _i64, _i64, _i64, _i64], None),
    "decode_golden_minsum": ([_I64, _I32, _i64, _i64, _i64, _F32, _i64, _i32,
                              _f32, _f32, _U8, _U8, _I32], None),
    "decode_golden_layered": ([_I64, _I32, _I32, _I64, _i64, _i64, _i64, _i64,
                               _F32, _i64, _i32, _f32, _f32, _U8, _U8, _I32], None),
    "decode_golden_flooding": ([_I64, _I32, _I32, _i64, _i64, _i64, _F32, _i64,
                                _i32, _f32, _f32, _i32, _U8, _U8, _I32], None),
    "decode_golden_sp_ref": ([_I64, _I32, _I64, _I32, _i64, _i64, _i64, _F32,
                              _i64, _i32, _f32, _U8, _U8, _I32], None),
}


def find_cxx() -> str:
    """Path of the C++ compiler; raises ``RuntimeError`` without one."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library "
                           "(myldpccppapi_torch/native) needs a C++ compiler")
    return cxx


def _lib_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        digest.update((_DIR / name).read_bytes())
    return _BUILD / f"libmyldpc_native-{digest.hexdigest()[:16]}.so"


def build() -> tuple[pathlib.Path, float | None]:
    """Build the library unless it exists.  Returns its path and the wall
    seconds of the compile (``None`` when it was already built)."""
    lib_path = _lib_path()
    if lib_path.exists():
        return lib_path, None
    cxx = find_cxx()
    _BUILD.mkdir(exist_ok=True)
    # the library goes to a private name first: a concurrent build never
    # sees a half-written one
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        tmp_lib = os.path.join(tmp, "lib.so")
        t0 = time.perf_counter()
        try:
            run = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp_lib,
                                  *(str(_DIR / name) for name in SOURCES)],
                                 capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(f"cannot run the C++ compiler {cxx}: {exc}") from exc
        if run.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build the native host library:\n"
                               f"{run.stdout}{run.stderr}")
        seconds = time.perf_counter() - t0
        os.replace(tmp_lib, lib_path)
    return lib_path, seconds


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the library."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


# -- packed rows (NumPy side) -------------------------------------------------

def pack_rows(m: np.ndarray) -> np.ndarray:
    """[r, c] 0/1 -> [r, ceil(c/64)] uint64, bit c in word c//64 at c%64."""
    m = np.asarray(m, dtype=np.uint8) & 1
    r, c = m.shape
    pad = (-c) % 64
    if pad:
        m = np.concatenate([m, np.zeros((r, pad), np.uint8)], axis=1)
    by = np.packbits(m.reshape(r, -1, 8), axis=-1, bitorder="little")[..., 0]
    return by.reshape(r, -1, 8).view(np.uint64).reshape(r, -1).copy()


def unpack_rows(p: np.ndarray, cols: int) -> np.ndarray:
    """Inverse of :func:`pack_rows` -> [r, cols] bool."""
    r = p.shape[0]
    bits = np.unpackbits(p.view(np.uint8).reshape(r, -1), axis=-1,
                         bitorder="little")
    return bits[:, :cols].astype(np.bool_)


# -- byte stream and GF(2) ----------------------------------------------------

def pack_bits(bits: np.ndarray) -> np.ndarray:
    """[..., L*8] 0/1 -> [..., L] uint8, LSB-first."""
    bits = np.ascontiguousarray(np.asarray(bits, np.uint8))
    if bits.shape[-1] % 8 != 0:
        raise ValueError("bit length must be a multiple of 8")
    out = np.empty(bits.shape[:-1] + (bits.shape[-1] // 8,), np.uint8)
    load().pack_bits_lsb(bits.reshape(-1), out.reshape(-1), out.size)
    return out


def unpack_bits(data: np.ndarray) -> np.ndarray:
    """[..., L] uint8 -> [..., L*8] 0/1, LSB-first."""
    data = np.ascontiguousarray(np.asarray(data, np.uint8))
    out = np.empty(data.shape[:-1] + (data.shape[-1] * 8,), np.uint8)
    load().unpack_bits_lsb(data.reshape(-1), out.reshape(-1), data.size)
    return out


def rref_packed(m: np.ndarray):
    """Reduced row-echelon form over GF(2) of a 0/1 matrix: (rref [rank, c]
    bool, pivot_cols [rank] int64)."""
    mb = np.asarray(m)
    r, c = mb.shape
    p = pack_rows(mb)
    piv = np.zeros(r, dtype=np.int64)
    rank = load().gf2_rref_packed(p, r, c, p.shape[1], piv)
    return unpack_rows(p[:rank], c), piv[:rank]


def inv_packed(m: np.ndarray) -> np.ndarray:
    """GF(2) inverse of a square 0/1 matrix as bool; raises
    ``np.linalg.LinAlgError`` if it is singular."""
    mb = np.asarray(m)
    n = mb.shape[0]
    if mb.shape != (n, n):
        raise ValueError(f"expected square matrix, got {mb.shape}")
    p = pack_rows(mb)
    ident = pack_rows(np.eye(n, dtype=np.uint8))
    if load().gf2_inv_packed(p, ident, n, p.shape[1]) != 0:
        raise np.linalg.LinAlgError("matrix is singular over GF(2)")
    return unpack_rows(ident, n)


def matmul_packed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a @ b) mod 2 of 0/1 matrices, as bool."""
    a, b = np.asarray(a), np.asarray(b)
    ra, ca = a.shape
    if b.shape[0] != ca:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    cb = b.shape[1]
    pa, pb = pack_rows(a), pack_rows(b)
    pc = np.zeros((ra, pb.shape[1]), dtype=np.uint64)
    load().gf2_matmul_packed(pa, pb, pc, ra, ca, cb, pa.shape[1], pb.shape[1])
    return unpack_rows(pc, cb)


# -- golden decoders ----------------------------------------------------------

def _row_csr(code):
    """(row_ptr int64[m+1], cols int32[E]) of H's edges sorted by row."""
    rows, cols = code.h_coo()
    order = np.argsort(rows, kind="stable")
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rows[order], minlength=code.m))]).astype(np.int64)
    return row_ptr, np.ascontiguousarray(cols[order], dtype=np.int32), cols[order]


def _io(code, llr):
    """The LLRs as C-contiguous f32 [B, n] and the three output buffers."""
    llr = np.ascontiguousarray(np.atleast_2d(llr), dtype=np.float32)
    if llr.ndim != 2 or llr.shape[1] != code.n:
        raise ValueError(f"expected LLRs [batch, {code.n}], got {llr.shape}")
    b = llr.shape[0]
    return (llr, np.empty((b, code.n), np.uint8), np.empty(b, np.uint8),
            np.empty(b, np.int32))


#: layered edge plans, one per live code object (identity keys: a plan
#: never outlives its code, so a new code never meets a freed one's plan)
_LAYERED_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _layered_plan(code):
    """Edge plan of the layered and exact-order flooding goldens, in
    ``ops/bp.py``'s write-back order.

    Enumerates the code's edges in (layer, block entry, check row) order,
    then stable-sorts them by global check row into the CSR the check
    update walks (within a row the stable sort keeps block-entry order, so
    ties of the minimum go to the lowest entry, as in ``ops/bp.py``).  A
    block aligns its rows cyclically (``QCCode``) or by XOR
    (``RSLDPCCode``'s ``group = "xor"``).  Returns (row_ptr int64[m+1],
    cols int32[E], wb_perm int32[E], layer_row_ptr int64[m_b+1]).
    """
    hit = _LAYERED_PLANS.get(code)
    if hit is not None:
        return hit
    br, bc, sh = code.blocks
    masks = code.block_row_masks
    ptr = np.asarray(code.layer_ptr)
    z = code.z
    xor = getattr(code, "group", "cyclic") == "xor"
    rows_en, cols_en = [], []
    for li in range(code.m_b):
        for e in range(int(ptr[li]), int(ptr[li + 1])):
            r = np.arange(z)
            if masks[e] is not None:
                r = r[np.asarray(masks[e])]
            rows_en.append(li * z + r)
            aligned = (r ^ int(sh[e])) if xor else (r + int(sh[e])) % z
            cols_en.append(int(bc[e]) * z + aligned)
    rows_en = np.concatenate(rows_en).astype(np.int64)
    cols_en = np.concatenate(cols_en).astype(np.int64)
    order = np.argsort(rows_en, kind="stable")
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    plan = (
        np.concatenate([[0], np.cumsum(np.bincount(rows_en, minlength=code.m))]
                       ).astype(np.int64),
        np.ascontiguousarray(cols_en[order], np.int32),
        np.ascontiguousarray(inv, np.int32),
        np.arange(code.m_b + 1, dtype=np.int64) * z,
    )
    _LAYERED_PLANS[code] = plan
    return plan


def decode_golden_native(code, llr: np.ndarray, max_iters: int = 40,
                         normalization: float = 1.0, offset: float = 0.0):
    """Flooding min-sum golden in C++ (the reference's ``decodeCPU``,
    ``MyLdpc.cpp:684-784``, f32, posterior adds in row order).  Returns
    (bits [B, n] uint8, converged [B] bool, iters [B] int32)."""
    lib = load()
    row_ptr, cols, _ = _row_csr(code)
    llr, bits, conv, iters = _io(code, llr)
    lib.decode_golden_minsum(
        row_ptr, cols, code.m, code.n, len(cols), llr.reshape(-1), llr.shape[0],
        max_iters, normalization, offset, bits.reshape(-1), conv, iters)
    return bits, conv.astype(bool), iters


def decode_golden_layered_native(code, llr: np.ndarray, max_iters: int = 40,
                                 normalization: float = 1.0,
                                 offset: float = 0.0):
    """Layered (TDMP) min-sum golden in C++: the layer order and delta
    write-back of ``ops/bp.py::decode_layered``, bit-exact with it in f32.
    Block codes only (a layer is a base row).  Returns (bits, converged,
    iters) as :func:`decode_golden_native`."""
    lib = load()
    row_ptr, cols, wb_perm, layer_row_ptr = _layered_plan(code)
    llr, bits, conv, iters = _io(code, llr)
    lib.decode_golden_layered(
        row_ptr, cols, wb_perm, layer_row_ptr, code.m_b, code.m, code.n,
        len(cols), llr.reshape(-1), llr.shape[0], max_iters, normalization,
        offset, bits.reshape(-1), conv, iters)
    return bits, conv.astype(bool), iters


def decode_golden_flooding_native(code, llr: np.ndarray, max_iters: int = 40,
                                  normalization: float = 1.0,
                                  offset: float = 0.0,
                                  self_correction: bool = False):
    """Flooding min-sum golden in C++ in ``ops/bp.py``'s exact f32 order
    (posterior adds block by block, the layered plan's write-back order),
    bit-exact with ``decode_flooding`` and kernel A's flooding mode; with
    ``self_correction`` the SCMS trajectory.  Block codes only.  Returns
    (bits, converged, iters)."""
    lib = load()
    row_ptr, cols, wb_perm, _ = _layered_plan(code)
    llr, bits, conv, iters = _io(code, llr)
    lib.decode_golden_flooding(
        row_ptr, cols, wb_perm, code.m, code.n, len(cols), llr.reshape(-1),
        llr.shape[0], max_iters, normalization, offset, int(bool(self_correction)),
        bits.reshape(-1), conv, iters)
    return bits, conv.astype(bool), iters


def decode_golden_sp_ref_native(code, llr: np.ndarray, max_iters: int = 40,
                                scale: float = 8.0):
    """Probability-domain flooding sum-product in C++ with the reference's
    arithmetic and channel quirk (``exp(scale * y)``, scale 8 =
    2/sigma^2 of ``decodeCL.c:9``; ``decodeCL.c:3-108``,
    ``MyLdpc.cpp:977-1059``).  Returns (bits, converged, iters)."""
    lib = load()
    row_ptr, cols, cols64 = _row_csr(code)
    # column adjacency in the reference's linked-list order: edges appended
    # row-major (MyLdpc.cpp:188-220), ascending edge index per column
    col_edges = np.ascontiguousarray(np.argsort(cols64, kind="stable"), np.int32)
    col_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(cols64, minlength=code.n))]).astype(np.int64)
    llr, bits, conv, iters = _io(code, llr)
    lib.decode_golden_sp_ref(
        row_ptr, cols, col_ptr, col_edges, code.m, code.n, len(cols),
        llr.reshape(-1), llr.shape[0], max_iters, scale, bits.reshape(-1),
        conv, iters)
    return bits, conv.astype(bool), iters
