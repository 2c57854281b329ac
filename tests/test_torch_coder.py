"""The port's byte-stream Coder and CLI `test` flow against the JAX
package's Coder on the same soft stream."""
import json

import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref

from myldpccppapi_torch import Coder, bench
from myldpccppapi_torch.cli import build_parser, main

torch.set_num_threads(1)


def _plaintext(n):  # 'a' + i % 26, like Test.cpp:44
    return bytes((ord("a") + i % 26) for i in range(n))


@pytest.fixture(scope="module")
def stream():
    """A soft stream made by the reference Coder (JAX noise), 4 dB."""
    theirs = ref.Coder(432, 576, "3/4B")
    theirs.for_encoder()
    src = _plaintext(1000)  # 19 codewords, the last one zero-padded
    prior = theirs.encode(src)
    return src, prior, theirs.test(prior, 10 ** (-4.0 / 20), seed=3)


@pytest.mark.parametrize("de_type", ["TDMP", "TDMPCL", "CPU"])
def test_decode_matches_reference_coder(stream, de_type):
    """CPU: the port's C++ golden (native/) against the reference's own
    default, its C++ golden, byte for byte on capped frames too."""
    src, _, post = stream
    mine = Coder(432, 576, "3/4B", device="cpu")
    theirs = ref.Coder(432, 576, "3/4B")
    for c in (mine, theirs):
        c.for_decoder(batch_size=8)
    out, stats = mine.decode(post, len(src), de_type, return_stats=True)
    want, want_stats = theirs.decode(post, len(src), de_type, return_stats=True)
    np.testing.assert_array_equal(out, want)
    for key in ("converged", "iterations"):
        np.testing.assert_array_equal(stats[key], want_stats[key], err_msg=key)
    assert stats["mean_iters"] == want_stats["mean_iters"]
    # 4 dB is below where every frame decodes: both sides see the same errors
    assert not stats["converged"].all()


@pytest.mark.parametrize("length", [200, 54 * 300 + 7])
def test_encode_matches_reference_coder(length):
    """Below 256 codewords the NumPy encode runs, above it the torch one."""
    mine, theirs = Coder(432, 576, "3/4B", device="cpu"), ref.Coder(432, 576, "3/4B")
    mine.for_encoder()
    theirs.for_encoder()
    src = _plaintext(length)
    np.testing.assert_array_equal(mine.encode(src), theirs.encode(src))


@pytest.mark.parametrize("length", [0, 1, 54, 55, 108, 1000])
def test_size_queries_match_reference(length):
    mine, theirs = Coder(432, 576, "3/4B", device="cpu"), ref.Coder(432, 576, "3/4B")
    for q in ("get_code_size", "get_prior_code_length", "get_post_code_length"):
        assert getattr(mine, q)(length) == getattr(theirs, q)(length), q


def test_roundtrip_and_refusals():
    coder = Coder(432, 576, "3/4B", device="cpu")
    coder.for_encoder()
    src = _plaintext(200)
    post = coder.test(coder.encode(src), 10 ** (-8.0 / 20), seed=0)
    assert post.dtype == np.float32 and len(post) == coder.get_post_code_length(200)
    assert bytes(coder.decode(post, len(src), "TDMPCL")) == src
    assert len(coder.decode(post, 0)) == 0
    # the bit-flipping tier, ported since: GDBF on the coder's device
    coder.add_decode_type("BF")
    assert coder._decoders["BF"].implementation == "gdbf"
    for de_type in ("MS", "SP", "MSCL", "SCMS", "BF"):
        assert bytes(coder.decode(post, len(src), de_type)) == src
    with pytest.raises(ValueError):
        coder.add_decode_type("BOGUS")
    with pytest.raises(ValueError):
        Coder(431, 576, "3/4B", device="cpu")
    with pytest.raises(RuntimeError):
        Coder(432, 576, "3/4B", device="cpu").encode(src)


@pytest.mark.parametrize("algo", ["CPU", "TDMP", "TDMPCL"])
def test_cli_test_roundtrip(algo, capsys):
    rc = main(["test", "432", "8", "7.0", algo, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "ErrNum=0" in out and "ThroughPut=" in out and "Time=" in out


def test_cli_rejects_unported_algo(capsys, monkeypatch):
    """Every reference decode type parses (BF, ported since, too); a name
    neither package knows does not.  ``bench``, ported since, runs: one
    JSON line with the record's fields (a batch of 64 on the CPU)."""
    with pytest.raises(SystemExit):
        build_parser().parse_args(["test", "432", "8", "5.0", "BOGUS"])
    assert build_parser().parse_args(["test", "432", "8", "5.0", "MS"]).algo == "MS"
    assert build_parser().parse_args(["test", "432", "8", "5.0", "BF"]).algo == "BF"
    monkeypatch.setattr(bench, "BATCH", 64)
    assert main(["bench", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "cpu_baseline_mbits",
                "batch_ms", "ms", "implementation", "conv", "mean_iters",
                "kernel_launches", "device"):
        assert key in record, key
    assert record["metric"] == "decoded_info_throughput_n576_r34B_layered_nms_5dB"
    assert record["unit"] == "Mbit/s" and record["device"] == "cpu"
    assert record["vs_baseline"] > 0 and record["cpu_baseline_mbits"] > 0
    assert len(record["ms"]) == bench.REPS and record["conv"] > 0.98
    assert record["value"] == pytest.approx(64 * 432 / record["batch_ms"] / 1e3)
