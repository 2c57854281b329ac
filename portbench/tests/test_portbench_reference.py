"""The table files, the reference's reading of them, and the reference
decoder, against the program: the tables equal the port's generated
ones; the reference's circulants equal the port's code block for block;
its encoder gives the port's codewords; its decoder equals the port's plain
torch path (``ops/bp.py``) bit for bit, on the short frame (a test table)
and on the configuration's long frame, in the exact and the lazy mode."""

import json

import numpy as np
import pytest
import torch

from myldpccppapi_torch.codes import dvbs2
from myldpccppapi_torch.codes.dvbs2 import (ira_encode_fn, parse_address_table,
                                            synthetic_address_table)
from myldpccppapi_torch.ops.bp import _decode_layered
from myldpccppapi_torch.utils.config import DecoderConfig
from portbench.reference import dvbs2 as rdv
from portbench.reference import qc as rqc
from portbench.spec import HERE
from portbench.tests.cells import SHORT

LONG = json.loads((HERE / "configs" / "dvbs2_64800_r12.json").read_text())
SHORT_CFG = dict(LONG, n=16200, k=7200)
#: (configuration, table file)
TABLES = {"dvbs2_64800_r12": (LONG, HERE / "configs" / LONG["table"]),
          "short": (SHORT_CFG, SHORT)}


def _ref(name):
    cfg, path = TABLES[name]
    return rdv.build(cfg, rdv.parse(path.read_text()))


def _port(name):
    cfg, path = TABLES[name]
    return dvbs2(cfg["n"], cfg["rate"], addresses=parse_address_table(path.read_text()))


def _circulants(code):
    br, bc, sh = code.blocks
    masks = code.block_row_masks
    return [(int(br[e]), int(bc[e]), int(sh[e]),
             () if masks[e] is None else tuple(int(r) for r in np.nonzero(~masks[e])[0]))
            for e in range(len(br))]


@pytest.mark.parametrize("name", TABLES)
def test_table_equals_the_ports_generated_table(name):
    cfg, path = TABLES[name]
    assert parse_address_table(path.read_text()) == synthetic_address_table(cfg["n"],
                                                                            cfg["rate"])


@pytest.mark.parametrize("name", TABLES)
def test_reference_reading_equals_the_ports_code(name):
    ref, port = _ref(name), _port(name)
    assert [(c.row, c.col, c.shift, c.excluded) for c in ref.circulants] == _circulants(port)
    assert (ref.n, ref.k, ref.edges) == (port.n, port.k, port.num_edges)


def test_long_frame_matches_its_configuration():
    ref = _ref("dvbs2_64800_r12")
    assert (ref.n, ref.k, ref.edges, ref.punctured_front) == (
        LONG["n"], LONG["k"], LONG["edges"], LONG["punctured_front"])


@pytest.mark.parametrize("name", TABLES)
def test_encoder_equals_the_ports(name):
    ref = _ref(name)
    u = torch.randint(0, 2, (2, ref.k), generator=torch.Generator().manual_seed(4),
                      dtype=torch.uint8)
    cw = rdv.encode(ref, u)
    assert torch.equal(cw, ira_encode_fn(_port(name))(u))
    assert rqc.syndrome_ok(ref, cw).all()
    cw[0, 5] ^= 1
    assert rqc.syndrome_ok(ref, cw).tolist() == [False, True]


def _llr(cw, snr, gen):
    sigma = 10 ** (-snr / 20)
    y = (1 - 2 * cw.float()) + sigma * torch.randn(cw.shape, generator=gen)
    return (2 / sigma ** 2) * y


@pytest.mark.parametrize("snr,lazy,beta", [(1.5, False, 0.0), (1.5, True, 0.0),
                                           (1.2, False, 0.25)])
def test_decoder_equals_the_plain_path_short(snr, lazy, beta):
    gen = torch.Generator().manual_seed(7)
    ref = _ref("short")
    cw = rdv.encode(ref, torch.randint(0, 2, (32, ref.k), generator=gen, dtype=torch.uint8))
    llr = _llr(cw, snr, gen)
    got = rqc.decode(ref, llr, 0.85, beta, 30, True, lazy, block=20)
    want = _decode_layered(_port("short"), DecoderConfig(normalization=0.85, offset=beta,
                                                         max_iters=30),
                           llr, lazy=lazy, group_rounding=True)
    assert not got.converged.all() and got.converged.any()  # both kinds of frame
    assert torch.equal(got.bits, want.bits)
    assert torch.equal(got.converged, want.converged)
    assert torch.equal(got.iterations, want.iterations)


def test_decoder_equals_the_plain_path_long_lazy():
    """The 64800 code: multi-edge cells, the masked wrap row, lazy syndrome."""
    gen = torch.Generator().manual_seed(5)
    ref = _ref("dvbs2_64800_r12")
    cw = rdv.encode(ref, torch.randint(0, 2, (3, ref.k), generator=gen, dtype=torch.uint8))
    llr = _llr(cw, 1.1, gen)
    cfg = DecoderConfig(normalization=0.85, max_iters=12, syndrome_mode="lazy")
    got = rqc.decode(ref, llr, 0.85, 0.0, 12, True, True)
    want = _decode_layered(_port("dvbs2_64800_r12"), cfg, llr, lazy=True,
                           group_rounding=True)
    assert torch.equal(got.bits, want.bits)
    assert torch.equal(got.converged, want.converged)
    assert torch.equal(got.iterations, want.iterations)
