"""The port's error-impulse probe against the JAX package's on the CPU:
the same patterns decoded by both packages' decoders (layered, alpha 0.9,
60 iterations by default) give the same ``ImpulseReport`` in every field,
and the CLI ``probe`` prints the reference's lines.  The decodes are
bit-exact in f32 min-sum, so no tolerance."""
import dataclasses

import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu import cli as ref_cli
from myldpccppapi_tpu.ops import impulse as ref_impulse

from myldpccppapi_torch.cli import main
from myldpccppapi_torch.codes import wimax
from myldpccppapi_torch.ops import impulse
from myldpccppapi_torch.utils.config import DecoderConfig

torch.set_num_threads(1)


def _equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("kw", [
    dict(),
    dict(columns=[0, 5], amplitude=6.0),
    dict(max_pair_patterns=40, seed=3, batch=50),
], ids=["defaults", "columns", "sampled pairs"])
def test_report_equals_reference(kw):
    got = impulse.impulse_probe(wimax(576, "1/2"), device="cpu", **kw)
    want = ref_impulse.impulse_probe(ref.wimax(576, "1/2"), **kw)
    _equal(got, want)
    assert got.probes > 0
    if not kw:  # the defaults find a low-weight codeword of wimax 576 r1/2
        assert got.min_weight is not None and got.min_weight <= 20
    if got.min_weight is not None:  # the found support is a codeword
        code = wimax(576, "1/2")
        cw = np.zeros((1, code.n), dtype=np.uint8)
        cw[0, got.support] = 1
        assert not code.syndrome(cw).any() and cw.sum() == got.min_weight


def test_custom_config_and_pairs_equal_reference():
    code, ref_code = wimax(576, "3/4B"), ref.wimax(576, "3/4B")
    rng, ref_rng = np.random.default_rng(1), np.random.default_rng(1)
    assert impulse._structured_pairs(code, 50, rng) == \
        ref_impulse._structured_pairs(ref_code, 50, ref_rng)
    cfg = dict(normalization=0.75, max_iters=20)
    got = impulse.impulse_probe(code, DecoderConfig(**cfg), columns=[2],
                                max_pair_patterns=64, device="cpu")
    want = ref_impulse.impulse_probe(ref_code, ref.DecoderConfig(**cfg), columns=[2],
                                     max_pair_patterns=64)
    _equal(got, want)


def test_cli_probe_lines_equal_reference(capsys):
    argv = ["probe", "--max-pairs", "64"]
    assert main(argv + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out
    args = ref_cli.build_parser().parse_args(argv)
    args.fn(args)
    assert mine == capsys.readouterr().out
    assert mine.startswith("code=wimax_n576_r12 probes=")
