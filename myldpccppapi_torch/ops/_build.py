"""Build and load the CUDA kernels of ``myldpccppapi_torch/csrc``.

The sources have a plain ``extern "C"`` interface and include no PyTorch
header, so ``nvcc`` compiles each in seconds; :func:`build` starts one
``nvcc`` per object, all together (``bp_layered.cu`` as two objects, its
cyclic and xor groups; ``bp_long.cu`` as four, its f32 and bf16 min-sum
and sum-product instantiations; ``op_rate.cu``), and links the objects into
one shared library that :mod:`ctypes` loads.  The library goes into
``myldpccppapi_torch/_build/`` (listed in ``.gitignore``), named by a hash
of every source and header and the flags, and is built at first use, never
at import.
A machine with CUDA but without ``nvcc`` raises: there is no fallback.
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
from concurrent.futures import ThreadPoolExecutor

__all__ = ["build", "load", "find_nvcc", "HEADERS", "SOURCES"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
#: the kernel sources
SOURCES = ("bp_layered.cu", "bp_long.cu", "op_rate.cu")
#: the headers they include from csrc
HEADERS = ("phi.cuh",)
#: the objects, (source, its own flags), each compiled by its own nvcc
#: process: bp_layered.cu's two parts (BP_LAYERED_PART: the cyclic and the
#: xor group's instantiations) and bp_long.cu's four (BP_LONG_PART: its
#: f32 and bf16 min-sum and sum-product instantiations) take comparable
#: times, so the build takes the longest one
_OBJECTS = (*(("bp_layered.cu", (f"-DBP_LAYERED_PART={part}",)) for part in (1, 2)),
            *(("bp_long.cu", (f"-DBP_LONG_PART={part}",)) for part in (1, 2, 3, 4)),
            ("op_rate.cu", ()))
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # keep the f32 operation order: no contracted multiply-adds
    "--fmad=false",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures: (argtypes, restype) per exported function
_SIGNATURES = {
    # fourteen tensors (the posterior output may be null), twelve ints,
    # the stream
    "ldpc_bp_layered": ([_P] * 14 + [_I] * 12 + [_P], _I),
    # (n, z, m_b, num_blocks, group_slots, mode, itemsize, device)
    #   -> codewords per thread block
    "ldpc_bp_layered_tile": ([_I] * 8, _I),
    # fifteen tensors (the posterior output and the P scratch may be null),
    # fifteen ints, the stream
    "ldpc_bp_long": ([_P] * 15 + [_I] * 15 + [_P], _I),
    # (n, z, m_b, num_blocks, n_masks, group_slots, max_row_degree,
    #  itemsize, device)
    #   -> 2 posterior in shared memory / 1 in global memory / 0 not served
    "ldpc_bp_long_fits": ([_I] * 9, _I),
    # (n, z, m_b, num_blocks, n_masks, multi_edge, group_slots,
    #  max_row_degree, lazy, sum_product, itemsize, placement)
    #   -> resident blocks per SM
    "ldpc_bp_long_blocks_per_sm": ([_I] * 12, _I),
    # (x, out, n, body, n_iter, stream)
    "ldpc_op_rate": ([_P, _P, _I, _I, _I, _P], _I),
}


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of myldpccppapi_torch are built from source at "
        "first use"
    )


def _lib_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    digest.update(repr(_OBJECTS).encode())
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((_CSRC / name).read_bytes())
    return _BUILD / f"libldpc_kernels-{digest.hexdigest()[:16]}.so"


def _compile(nvcc: str, job: tuple, obj: str) -> float:
    """Compile one object, ``job`` = (source, its own flags), to ``obj``;
    returns its wall seconds."""
    name, flags = job
    t0 = time.perf_counter()
    run = subprocess.run([nvcc, *_NVCC_FLAGS, *flags, "-c", "-o", obj,
                          str(_CSRC / name)], capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name} {' '.join(flags)}:\n"
                           f"{run.stdout}{run.stderr}")
    return time.perf_counter() - t0


def build() -> tuple[pathlib.Path, dict]:
    """Build the kernel library unless it exists.  Returns its path and the
    wall seconds of each step: one entry per object (its nvcc runs
    alongside the others) and ``"link"``; empty when it was already
    built."""
    lib_path = _lib_path()
    if lib_path.exists():
        return lib_path, {}
    nvcc = find_nvcc()
    _BUILD.mkdir(exist_ok=True)
    # objects and the library go to private names first: a concurrent
    # build never sees a half-written library
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        objs = [os.path.join(tmp, f"{i}.o") for i in range(len(_OBJECTS))]
        with ThreadPoolExecutor(len(_OBJECTS)) as pool:
            times = pool.map(functools.partial(_compile, nvcc), _OBJECTS, objs)
            seconds = {" ".join((name, *flags)): t
                       for (name, flags), t in zip(_OBJECTS, times)}
        t0 = time.perf_counter()
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *_NVCC_FLAGS, "-shared", "-o", tmp_lib, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link the kernel library:\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib_path)
        seconds["link"] = time.perf_counter() - t0
    return lib_path, seconds


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
