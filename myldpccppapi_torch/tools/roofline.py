"""The card's achieved arithmetic rates: kernel E's port.

Counterpart of ``benchmarks/roofline.py::calibrate_vpu_ops`` (its Pallas
loop, kernel E): the rate the card reaches on the decoders' kind of work,
measured, not taken from a data sheet, so that a kernel's bound
(``chip_smoke.bound``) is the card's own.  The kernel
(``csrc/op_rate.cu``, :func:`op_rate`) runs one of E's loop bodies on
chains held in registers, one element per thread, on a grid that fills
every SM (:func:`n_elements`), and writes the chains' sum per element:

=======  ====================================================  ===========
body     per element and iteration                               counted
=======  ====================================================  ===========
fma4     four chains of x * 1.0000001 + 0.001                    8 f32 ops
mix3     E's add/mul/min/abs/compare/select mix on three chains  11 f32 ops
mix4     E's sub/abs/min/compare/select/max mix on four chains   10 f32 ops
sfu      the decoders' phi on four chains: a clamp, expf, two    12 results
         log1pf                                                  (special)
mufu     four chains of x = lg2(ex2(x)), the bare MUFU           8 results
         instructions                                            (special)
=======  ====================================================  ===========

:func:`calibrate` times each body with CUDA events at two depths and
returns (hi - lo) operations over (t_hi - t_lo), as ``calibrate_vpu_ops``
does.  The f32 rate is fma4's: with ``--fmad=false`` its 8 counted
operations are 8 FP32 instructions (a mul and an add per chain), so it is
an instruction rate, to set beside the issue ceiling SMs x 128 lanes x
clock (:func:`ceilings`; the data sheet's 67e12 counts a fused multiply-add
as two).  mix3 and mix4 keep E's counts, which are not their instruction
counts (the compiler folds an abs into its consumer's operand), so their
rates are reported and used nowhere.  The special-function rate is mufu's,
one MUFU result per counted result, to set beside SMs x 16 x clock; sfu's
rate, the decoders' phi, describes that implementation, not the card.

:func:`op_rate_plain` is the kernel's plain version: the same bodies as
torch ops, E's ``_calib_bodies`` operation for operation (mufu with torch's
exp2 and log2, which the approximate instructions match to
:data:`MUFU_ATOL`); on the CPU :func:`op_rate` runs it, on the card it
launches the kernel or raises.  ``op_rate.launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import statistics

import torch

from ..ops import _build

__all__ = ["BODIES", "MUFU_ATOL", "calibrate", "ceilings", "n_elements",
           "op_rate", "op_rate_plain"]

#: body name -> (the kernel's body index, operations per element and
#: iteration: f32 operations, or special-function results for sfu, mufu)
BODIES = {"fma4": (0, 8), "mix3": (1, 11), "mix4": (2, 10), "sfu": (3, 12),
          "mufu": (4, 8)}
#: the two depths of :func:`calibrate` per body: long enough that the
#: difference is milliseconds of the card's time
DEPTHS = {"fma4": (20_000, 100_000), "mix3": (20_000, 100_000),
          "mix4": (20_000, 100_000), "sfu": (1_000, 5_000),
          "mufu": (5_000, 25_000)}
#: mufu against its plain version: ex2.approx and lg2.approx are within
#: about 2^-21 (relative, and absolute near 0) of the exact results, so an
#: iteration moves a chain of |x| < 6 by at most ~3e-6 from torch's; four
#: chains over 200 iterations stay within 3e-3 of it
MUFU_ATOL = 1e-2
_THREADS_PER_SM = 2048  # 8 blocks of 256 threads: full occupancy
#: issue rates per SM and clock on compute capability 9.0 (the CUDA C++
#: Programming Guide's arithmetic-instruction throughput table): FP32
#: adds, muls, compares, min/max and selects; MUFU ex2/lg2
_F32_PER_SM_CLOCK = 128
_MUFU_PER_SM_CLOCK = 16


def n_elements(device) -> int:
    """One element per thread of a grid that fills every SM of ``device``
    at full occupancy."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * _THREADS_PER_SM


def ceilings(device, sm_clock_hz: float) -> dict:
    """The card's issue ceilings at ``sm_clock_hz`` (its maximum SM clock,
    as ``nvidia-smi --query-gpu=clocks.max.sm`` reads it): ``"f32"`` FP32
    instructions/s and ``"mufu"`` special-function results/s."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {"f32": sms * _F32_PER_SM_CLOCK * sm_clock_hz,
            "mufu": sms * _MUFU_PER_SM_CLOCK * sm_clock_hz}


def _phi(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 1e-7, 30.0)
    ex = torch.exp(-x)
    return torch.log1p(ex) - torch.log1p(-ex)


def _fma4(c):
    return [x * 1.0000001 + 0.001 for x in c]


def _mix3(c):
    a, m, s = c
    a = a * 1.0000001 + 0.4999
    m = torch.minimum(m, a)
    b = torch.abs(a - m)
    s = torch.where(b < s, s + b, s * 0.998)
    a = a - m * 1e-7
    return [a, m, s]


def _mix4(c):
    return [torch.abs(c[0] - 1.0),
            torch.clamp(c[1] + 0.1, max=8.0),
            torch.where(c[2] < 4.0, c[2] + 1.0, c[2] - 7.9),
            torch.clamp(c[3] * 0.999, min=0.125)]


def _sfu(c):
    return [_phi(x) for x in c]


def _mufu(c):
    return [torch.log2(torch.exp2(x)) for x in c]


_PLAIN = {"fma4": (4, _fma4), "mix3": (3, _mix3), "mix4": (4, _mix4), "sfu": (4, _sfu),
          "mufu": (4, _mufu)}


def op_rate_plain(x: torch.Tensor, body: str, n_iter: int) -> torch.Tensor:
    """The kernel's plain version on any device: chain k starts at x +
    0.125 k, runs ``n_iter`` iterations of ``body``, and the chains are
    summed in order."""
    chains, fn = _PLAIN[body]
    c = [x + 0.125 * k for k in range(chains)]
    for _ in range(n_iter):
        c = fn(c)
    out = c[0]
    for v in c[1:]:
        out = out + v
    return out


def op_rate(x: torch.Tensor, body: str, n_iter: int) -> torch.Tensor:
    """``body`` for ``n_iter`` iterations on the chains of each element of
    float32 ``x``: the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}; choose from {sorted(BODIES)}")
    if x.dtype != torch.float32 or x.ndim != 1:
        raise ValueError(f"expected a 1-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return op_rate_plain(x, body, n_iter)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ldpc_op_rate(x.data_ptr(), out.data_ptr(), x.numel(),
                               BODIES[body][0], n_iter, stream)
    if err != 0:
        raise RuntimeError(f"op_rate kernel launch failed: CUDA error {err}")
    op_rate.launches += 1
    return out


op_rate.launches = 0


def _ms(fn, reps: int = 3) -> float:
    """Median CUDA-event time of ``fn`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def calibrate(device="cuda", seed: int = 0) -> dict:
    """Each body timed at its two depths on ``device`` (a card): returns
    ``{"f32_ops_per_s"`` (fma4's), ``"sfu_per_s"`` (mufu's),
    ``"phi_per_s"`` (sfu's), ``"elements", "bodies": {name: {"rate", "lo",
    "hi", "t_lo_ms", "t_hi_ms"}}}``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"calibrate measures a CUDA device, got {device}")
    elems = n_elements(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(elems, generator=gen, device=device)
    bodies = {}
    for name, (_, ops) in BODIES.items():
        lo, hi = DEPTHS[name]
        t_lo = _ms(lambda: op_rate(x, name, lo))
        t_hi = _ms(lambda: op_rate(x, name, hi))
        bodies[name] = {"rate": (hi - lo) * ops * elems / ((t_hi - t_lo) * 1e-3),
                        "lo": lo, "hi": hi, "t_lo_ms": t_lo, "t_hi_ms": t_hi}
    return {"f32_ops_per_s": bodies["fma4"]["rate"],
            "sfu_per_s": bodies["mufu"]["rate"],
            "phi_per_s": bodies["sfu"]["rate"], "elements": elems,
            "bodies": bodies}
