"""The PyTorch port stands alone: it never imports JAX or the JAX package,
and importing it builds nothing."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from myldpccppapi_torch.codes import wimax
from myldpccppapi_torch.ops import _build, cuda_bp
from myldpccppapi_torch.utils.config import DecoderConfig

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "myldpccppapi_torch"


def _run(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_leaves_jax_out():
    proc = _run(
        "import sys, myldpccppapi_torch, myldpccppapi_torch.cli, "
        "myldpccppapi_torch.interop, myldpccppapi_torch.ops.cuda_bp, "
        "myldpccppapi_torch.ops.cuda_long, myldpccppapi_torch.sim, "
        "myldpccppapi_torch.campaign, myldpccppapi_torch.codes.nr, "
        "myldpccppapi_torch.codes.tables, myldpccppapi_torch.tools.kernel_probe, "
        "myldpccppapi_torch.codes.dvbs2, myldpccppapi_torch.codes.dvbs2_designed, "
        "myldpccppapi_torch.utils.device, myldpccppapi_torch.ops.modulation, "
        "myldpccppapi_torch.ops.bicm_id, myldpccppapi_torch.ops.bp_edgelist, "
        "myldpccppapi_torch.codes.nr_transport\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'myldpccppapi_tpu')]\n"
        "assert not bad, bad\n"
    )
    assert proc.returncode == 0, proc.stderr


def test_no_file_imports_the_reference():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|myldpccppapi_tpu)\b", re.M)
    offenders = [
        str(p.relative_to(ROOT))
        for p in PKG.rglob("*.py")
        if pattern.search(p.read_text())
    ]
    assert offenders == []


def test_cuda_wrapper_imports_without_nvcc_and_builds_nothing():
    env = dict(os.environ)
    env.pop("CUDA_HOME", None)
    env["PATH"] = "/nonexistent"
    proc = _run(
        "import os\n"
        "from myldpccppapi_torch.ops import _build, cuda_bp, cuda_long\n"
        "assert _build.load.cache_info().currsize == 0\n"
        "before = sorted(os.listdir(_build._BUILD)) "
        "if _build._BUILD.exists() else []\n"
        "import myldpccppapi_torch\n"
        "after = sorted(os.listdir(_build._BUILD)) "
        "if _build._BUILD.exists() else []\n"
        "assert before == after, (before, after)\n"
        "assert cuda_bp.decode_qc_cuda.launches == 0\n"
        "assert cuda_long.decode_qc_long.launches == 0\n",
        env=env,
    )
    assert proc.returncode == 0, proc.stderr


def test_build_without_nvcc_raises(monkeypatch):
    """A machine without nvcc raises; nothing falls back."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_wrapper_refuses_other_devices_and_bad_inputs():
    code = wimax(576, "3/4B")
    cfg = DecoderConfig()
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_bp.decode_qc_cuda(code, cfg,
                               torch.empty((2, code.n), device="meta"))
    with pytest.raises(ValueError, match="float32"):
        cuda_bp.decode_qc_cuda(code, cfg, torch.zeros((2, code.n),
                                                      dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        cuda_bp.decode_qc_cuda(code, cfg, torch.zeros((2, code.n + 1)))
    assert cuda_bp.decode_qc_cuda.launches == 0
