"""Build and load the CUDA kernels of ``myldpccppapi_torch/csrc``.

The sources have a plain ``extern "C"`` interface and include no PyTorch
header, so ``nvcc`` builds them in seconds into a shared library that
:mod:`ctypes` loads.  The library goes into ``myldpccppapi_torch/_build/``
(listed in ``.gitignore``), named by a hash of the sources and flags, and is
built at first use, never at import.  A machine with CUDA but without
``nvcc`` raises: there is no fallback.
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

__all__ = ["load", "find_nvcc"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # keep the f32 operation order: no contracted multiply-adds
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of ldpc_bp_layered: ten tensors, eight ints, the stream
_BP_LAYERED_ARGTYPES = [_P] * 10 + [_I] * 8 + [_P]


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


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/bp_layered.cu``."""
    src = _CSRC / "bp_layered.cu"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    lib_path = _BUILD / f"libbp_layered-{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        nvcc = find_nvcc()
        _BUILD.mkdir(exist_ok=True)
        # build to a private name, then rename: a concurrent builder never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *_NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src.name}:\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    lib.ldpc_bp_layered.argtypes = _BP_LAYERED_ARGTYPES
    lib.ldpc_bp_layered.restype = ctypes.c_int
    # (n, z, m_b, num_blocks, device) -> codewords per thread block
    lib.ldpc_bp_layered_tile.argtypes = [_I] * 5
    lib.ldpc_bp_layered_tile.restype = ctypes.c_int
    return lib
