"""Kernel E's plain version (``myldpccppapi_torch/tools/roofline.py``)
against the TPU calibration loop's own bodies
(``benchmarks/roofline.py::_calib_bodies``) run by ``jax.lax.fori_loop``
on the CPU, on the same NumPy tile.  benchmarks/roofline.py is loaded by
its path and not changed.

Tolerance: rtol = 1e-5, atol = 1e-3.  XLA on the CPU does not keep torch's
operation order bit for bit (it may fuse or reassociate a body's adds);
over 100 iterations the largest differences measured were ~1e-4 (fma4),
~2e-3 on values near 2.4e3 (mix3, relative ~1e-6) and 0 (mix4).  On the
card the kernel is held bit-exact against this plain version
(chip_smoke.py phase 6)."""
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myldpccppapi_torch.tools import roofline

torch.set_num_threads(1)

DEPTH = 100
RTOL, ATOL = 1e-5, 1e-3
_PATH = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "roofline.py"


def _reference_module():
    spec = importlib.util.spec_from_file_location("reference_roofline", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_module()
BODIES = {name: (ops, init, body) for name, ops, init, body in REF._calib_bodies()}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_plain_bodies_match_the_tpu_loop(name):
    ops, init, body = BODIES[name]
    assert roofline.BODIES[name][1] == ops  # the same operation count
    x = np.random.default_rng(3).standard_normal(REF.CALIB_SHAPE).astype(np.float32)
    chains = jax.lax.fori_loop(0, DEPTH, body, init(jnp.asarray(x)))
    want = np.asarray(functools.reduce(jnp.add, chains))
    got = roofline.op_rate(torch.from_numpy(x.reshape(-1)), name, DEPTH)
    np.testing.assert_allclose(got.numpy().reshape(REF.CALIB_SHAPE), want,
                               rtol=RTOL, atol=ATOL)


def test_sfu_body_is_the_decoders_phi():
    """The fourth body runs phi, the sum-product check update's transform
    (ops/bp.py::_phi), on four chains starting at x + 0.125 k."""
    from myldpccppapi_torch.ops.bp import _phi

    x = torch.from_numpy(np.random.default_rng(4).standard_normal(512).astype(np.float32))
    chains = [x + 0.125 * k for k in range(4)]
    for _ in range(7):
        chains = [_phi(c) for c in chains]
    want = ((chains[0] + chains[1]) + chains[2]) + chains[3]
    assert torch.equal(roofline.op_rate(x, "sfu", 7), want)
    assert torch.isfinite(roofline.op_rate(x, "sfu", DEPTH)).all()


def test_mufu_body_plain_version():
    """The fifth body, mufu, runs x = log2(2^x) on four chains starting at
    x + 0.125 k (the kernel's bare ex2/lg2 instructions; on the card
    within roofline.MUFU_ATOL of this), and stays finite at depth."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(512).astype(np.float32))
    chains = [x + 0.125 * k for k in range(4)]
    for _ in range(7):
        chains = [torch.log2(torch.exp2(c)) for c in chains]
    want = ((chains[0] + chains[1]) + chains[2]) + chains[3]
    assert torch.equal(roofline.op_rate(x, "mufu", 7), want)
    got = roofline.op_rate(x, "mufu", DEPTH)
    assert torch.isfinite(got).all()
    assert float((got - 4 * x - 0.75).abs().max()) < roofline.MUFU_ATOL


def test_wrapper_refuses_bad_inputs():
    with pytest.raises(ValueError, match="unknown body"):
        roofline.op_rate(torch.zeros(4), "fma8", 1)
    with pytest.raises(ValueError, match="float32"):
        roofline.op_rate(torch.zeros(4, dtype=torch.float64), "fma4", 1)
    with pytest.raises(ValueError, match="unsupported device"):
        roofline.op_rate(torch.empty(4, device="meta"), "fma4", 1)
    with pytest.raises(ValueError, match="CUDA"):
        roofline.calibrate(device="cpu")
    assert roofline.op_rate.launches == 0
