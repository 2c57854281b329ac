"""bf16 messages against the JAX package on the CPU.

* The plain bf16 path with kernel A's rounding (every operation rounds to
  bf16; the default of ``ops/bp.py``) against the jnp bf16 path on the
  reference's own point (tests/test_bf16.py: wimax 576 r3/4B, 5.5 dB, 16
  frames), min-sum and sum-product: every frame converges to the true info
  bits on both sides, and all 16 frames agree bit for bit (bits and
  iterations) at this point.  bf16 is pinned statistically in the
  reference (BENCH_NOTES "bf16 exactness policy"); the per-frame agreement
  is what this point shows, not a contract.
* Kernel C's plain version (``cuda_long.decode_qc_long_plain``, rounding
  at kernel C's points) is bit-exact with the TPU kernel ``decode_qc_zlane``
  in bf16 in interpret mode, posteriors included, on a z=64 code with a
  multi-edge cell and a masked row at a mixed-convergence point; kernel
  A's rounding points give other posteriors there.
* In f32 the two sets of rounding points are one function.
* Soft output returns bf16 posteriors; ``msg_dtype="float16"`` raises.
The CUDA kernels themselves run only on a card (chip_smoke.py)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.codes import encode_numpy as ref_encode_numpy
from myldpccppapi_tpu.ops.channel import transmit as ref_transmit
from myldpccppapi_tpu.ops.pallas_zlane import decode_qc_zlane

from myldpccppapi_torch import Coder, Decoder, DecoderConfig, interop
from myldpccppapi_torch.cli import main
from myldpccppapi_torch.ops import bp, cuda_bp, cuda_long

from test_torch_long import _random_qc

torch.set_num_threads(1)

FIELDS = ("bits", "converged", "iterations", "total_iters")
BF16 = dict(msg_dtype="bfloat16")


@pytest.fixture(scope="module")
def wimax_case():
    """tests/test_bf16.py's case: wimax 576 r3/4B, 16 frames, 5.5 dB."""
    rcode = ref.wimax(576, "3/4B")
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, size=(16, rcode.k), dtype=np.uint8)
    c = ref_encode_numpy(ref.Encoder(rcode).mats, u)
    llr, _ = ref_transmit(jax.random.PRNGKey(0), jnp.asarray(c), snr_db=5.5)
    return rcode, u, np.array(llr)


@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
def test_bf16_decodes_like_the_jnp_path(wimax_case, algorithm):
    rcode, u, llr = wimax_case
    kw = dict(algorithm=algorithm, schedule="layered",
              normalization=0.75 if algorithm == "min-sum" else 1.0, **BF16)
    want = ref.Decoder(rcode, ref.DecoderConfig(**kw), implementation="jnp")(llr)
    got = Decoder(interop.code_from_reference(rcode), DecoderConfig(**kw),
                  device="cpu")(torch.from_numpy(llr))
    for bits, conv in ((np.asarray(want.bits), np.asarray(want.converged)),
                       (got.bits.numpy(), got.converged.numpy())):
        assert conv.all()
        np.testing.assert_array_equal(bits[:, : rcode.k], u)
    agree = ((got.bits.numpy() == np.asarray(want.bits)).all(axis=1)
             & (got.iterations.numpy() == np.asarray(want.iterations)))
    assert int(agree.sum()) == 16


@pytest.mark.parametrize("soft", [True, False])
def test_kernel_c_plain_version_matches_zlane_bf16(soft):
    """A z=64 code with a multi-edge cell and a masked row, LLRs around
    the all-zero codeword at a point where 14 of 16 frames converge."""
    rcode = _random_qc(64, extra=True, masked=True)
    code = interop.code_from_reference(rcode)
    llr = np.random.default_rng(0).normal(3.0, 2.0, (16, code.n)).astype(np.float32)
    rcfg = ref.DecoderConfig(schedule="layered", normalization=0.75, max_iters=10,
                             soft_output=soft, **BF16)
    want = decode_qc_zlane(rcode, rcfg, jnp.asarray(llr), True)
    cfg = interop.config_from_reference(rcfg)
    got = cuda_long.decode_qc_long(code, cfg, torch.from_numpy(llr))  # CPU: plain
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert int(got.converged.sum()) == 14
    if soft:
        assert got.posteriors.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.posteriors.float().numpy(),
                                      np.asarray(want.posteriors.astype(jnp.float32)))
        # kernel A's rounding points are another function
        per_op = bp.decode_qc(code, cfg, torch.from_numpy(llr))
        assert not torch.equal(per_op.posteriors, got.posteriors)


@pytest.mark.parametrize("extra", [False, True])
def test_rounding_points_agree_in_f32(extra):
    """In f32, kernel C's grouped write-back is the per-edge one."""
    code = interop.code_from_reference(_random_qc(64, extra=extra, masked=extra))
    llr = torch.from_numpy(np.random.default_rng(1).normal(2.5, 2.0, (8, code.n))
                           .astype(np.float32))
    cfg = DecoderConfig(normalization=0.8, max_iters=8, soft_output=True)
    got = cuda_long.decode_qc_long_plain(code, cfg, llr)
    want = bp.decode_qc(code, cfg, llr)
    for f in FIELDS + ("posteriors",):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_soft_output_is_bf16(wimax_case, schedule):
    rcode, u, llr = wimax_case
    code = interop.code_from_reference(rcode)
    cfg = DecoderConfig(schedule=schedule, normalization=0.75, soft_output=True, **BF16)
    got = Decoder(code, cfg, device="cpu")(torch.from_numpy(llr))
    assert got.posteriors.dtype == torch.bfloat16
    assert got.posteriors.shape == (16, code.n)
    assert torch.equal(got.posteriors <= 0, got.bits.bool())
    # the short-code kernel's plain version is the same function
    plain = cuda_bp.decode_qc_cuda(code, cfg, torch.from_numpy(llr))
    assert torch.equal(plain.posteriors, got.posteriors)


def test_bf16_rejects_bad_dtype():
    with pytest.raises(ValueError):
        DecoderConfig(msg_dtype="float16")


def test_cli_and_coder_take_bf16(tmp_path, capsys):
    """``waterfall --msg-dtype bfloat16`` is another campaign (the config is
    in the fingerprint); ``test --msg-dtype`` and the Coder decode in bf16."""
    ck = tmp_path / "ck.json"
    argv = ["waterfall", "--family", "wimax", "--snr=2.5", "--batch", "8",
            "--target-errors", "1", "--max-frames", "8", "--max-iters", "8",
            "--checkpoint", str(ck), "--device", "cpu"]
    assert main(argv) == 0
    f32 = json.loads(ck.read_text())["fingerprint"]
    assert main([*argv, "--msg-dtype", "bfloat16"]) == 0
    assert json.loads(ck.read_text())["fingerprint"] != f32
    assert capsys.readouterr().out.count("snr=+2.50") == 2
    assert main(["test", "432", "8", "6.0", "TDMPCL", "--msg-dtype", "bfloat16",
                 "--device", "cpu"]) == 0
    assert "ErrNum=0" in capsys.readouterr().out
    coder = Coder(432, 576, "3/4B", device="cpu", msg_dtype="bfloat16")
    coder.add_decode_type("SP")
    assert coder._decoders["SP"].config.msg_dtype == "bfloat16"
