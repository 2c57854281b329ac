"""Dispatch parity: the port's ``Decoder`` dispatch on a modelled CUDA
device against the reference's on a modelled TPU.

The reference (``myldpccppapi_tpu/decoder.py::_implementation``) runs a
Pallas kernel where its gate admits a request and sends the rest to its
jnp path, XLA ops on the same device.  The port
(``myldpccppapi_torch/decoder.py::_implementation``) runs a CUDA kernel
where one serves the request and sends the rest to its torch path, torch
ops on the card.  On a grid of codes and configs the port's answer must
be the counterpart of the reference's, with each difference listed in
:data:`EXCEPTIONS` and its reason.

Neither device is present.  The reference's gates read
``jax.devices()[0].platform``, so ``jax.devices`` is patched to report a
TPU.  The port's gates ask the card for kernel A's occupancy
(``cuda_bp._blocks_per_sm``) and kernel C's fit (``cuda_long.placement``);
they are stubbed with a model of the H100: kernel A's shared-memory and
register rule (``test_torch_short_lanes.model_blocks_per_sm``) and the
placements chip_smoke.py's runs report (NR and DVB-S2 16200 in shared
memory, DVB-S2 64800 in global memory).
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from functools import partial
from types import SimpleNamespace

import jax
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu import coder as ref_coder
from myldpccppapi_tpu import decoder as ref_decoder
from myldpccppapi_tpu.codes import dvbs2 as ref_dvbs2
from myldpccppapi_tpu.codes import nr_code as ref_nr_code
from myldpccppapi_tpu.codes import wifi as ref_wifi
from myldpccppapi_tpu.codes import wimax as ref_wimax
from myldpccppapi_tpu.codes.rs_ldpc import rs_ldpc_from_n as ref_rs_ldpc_from_n

from myldpccppapi_torch import Coder, Decoder, decoder, interop
from myldpccppapi_torch.coder import DECODE_TYPES
from myldpccppapi_torch.ops import bp, cuda_bp, cuda_long
from myldpccppapi_torch.utils.config import DecoderConfig
from test_torch_short_lanes import model_blocks_per_sm

torch.set_num_threads(1)

CUDA = torch.device("cuda", 0)

#: the reference's implementation names -> the port's
COUNTERPART = {"pallas": "cuda", "pallas_zlane": "cuda_long",
               "pallas_stream": "cuda_long", "jnp": "torch", "edgelist": "edgelist"}

#: the grid's codes: the reference's constructors (the port's codes are
#: carried across by interop)
CODES = {
    "wimax576": lambda: ref_wimax(576, "3/4B"),
    "wifi1944": lambda: ref_wifi(1944, "5/6"),
    "nr_bg1_z32": lambda: ref_nr_code(32, 1),
    "nr_bg2_z32": lambda: ref_nr_code(32, 2),
    "nr_bg1_z64": lambda: ref_nr_code(64, 1),
    "nr_bg2_z64": lambda: ref_nr_code(64, 2),
    "nr_bg1_z384": lambda: ref_nr_code(384, 1),
    "nr_bg2_z384": lambda: ref_nr_code(384, 2),
    "dvbs2_16200": lambda: ref_dvbs2(16200, "1/2"),
    "dvbs2_64800": lambda: ref_dvbs2(64800, "1/2"),
    "rs_ldpc_2048": lambda: ref_rs_ldpc_from_n(2048),
    "rs_ldpc_8192": lambda: ref_rs_ldpc_from_n(8192),
}

#: the grid's configs (DecoderConfig fields); "per-layer" gets one alpha
#: per base row, "per-iteration" a nested schedule (the learned kind)
CONFIGS = {
    "layered": {},
    "flooding": dict(schedule="flooding"),
    "scms": dict(schedule="flooding", self_correction=True),
    "sp layered": dict(algorithm="sum-product"),
    "sp flooding": dict(schedule="flooding", algorithm="sum-product"),
    "soft layered": dict(soft_output=True),
    "soft flooding": dict(schedule="flooding", soft_output=True),
    "bf16": dict(msg_dtype="bfloat16"),
    "per-layer": "per-layer",
    "per-iteration": dict(normalization=((0.8,), (0.7,)), max_iters=5),
    "triage": dict(triage_iters=5),
    "crc": dict(crc="16"),
    "lazy": dict(syndrome_mode="lazy"),
}

_ROUTE_B = ("kernel B's route (csrc/bp_layered.cu's table-driven sweep) serves "
            "layered min-sum with scalar weights on the NR codes of more than "
            "120 circulants with z < 64; the reference keeps its table-driven "
            "kernel B out of auto dispatch (pallas_bp.py:136-141) and sends "
            "them to its streaming kernel D")
_ROUTE_B_BF16 = ("kernel B's route serves bf16 messages, which the TPU's "
                 "streaming kernel refuses (pallas_stream.py:83-87), so the "
                 "reference takes jnp")

#: (code, config) -> (the reference's answer, the port's, why they differ)
EXCEPTIONS = {
    **{(code, cfg): ("pallas_stream", "cuda", _ROUTE_B)
       for code in ("nr_bg1_z32", "nr_bg2_z32")
       for cfg in ("layered", "triage", "crc", "lazy")},
    **{(code, "bf16"): ("jnp", "cuda", _ROUTE_B_BF16)
       for code in ("nr_bg1_z32", "nr_bg2_z32")},
}


class _Tpu:
    platform = "tpu"


@pytest.fixture
def modelled_devices(monkeypatch):
    """A TPU for the reference's gates, an H100 for the port's."""
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [_Tpu()])
    monkeypatch.setattr(
        cuda_bp, "_blocks_per_sm",
        lambda code, index, mode_bits, itemsize: tuple(
            model_blocks_per_sm(code, mode_bits, regs_per_thread=32)))
    monkeypatch.setattr(
        cuda_long, "placement",
        lambda code, index, itemsize=4: (cuda_long.GLOBAL if code.n >= 64800
                                         else cuda_long.SHARED))


@functools.lru_cache(maxsize=None)
def _codes(name: str):
    theirs = CODES[name]()
    return theirs, interop.code_from_reference(theirs)


def _config_fields(name: str, m_b: int) -> dict:
    kw = CONFIGS[name]
    return dict(normalization=(0.8,) * m_b) if kw == "per-layer" else kw


def _both(code_name: str, cfg_name: str):
    """(the reference's implementation, the port's, the port's code and
    config) for one grid case on the modelled devices."""
    theirs, mine = _codes(code_name)
    kw = _config_fields(cfg_name, mine.m_b)
    want = ref_decoder._implementation(ref.DecoderConfig(**kw), theirs)
    cfg = DecoderConfig(**kw)
    return want, decoder._implementation(mine, cfg, CUDA), mine, cfg


GRID = [(c, k) for c in CODES for k in CONFIGS]


@pytest.mark.parametrize("code_name,cfg_name", GRID)
def test_dispatch_is_the_references_counterpart(modelled_devices, code_name, cfg_name):
    want, got, _, _ = _both(code_name, cfg_name)
    if (code_name, cfg_name) in EXCEPTIONS:
        ref_impl, port_impl, why = EXCEPTIONS[(code_name, cfg_name)]
        assert (want, got) == (ref_impl, port_impl), why
    else:
        assert got == COUNTERPART[want], (want, got)


@pytest.mark.parametrize("code_name", list(CODES))
def test_torch_only_where_no_kernel_serves(modelled_devices, code_name):
    """"auto" keeps every request a kernel's gate admits on that kernel, in
    the order short, long, and takes the torch path only where neither
    admits it; an explicit kernel there still raises."""
    for cfg_name in CONFIGS:
        _, got, code, cfg = _both(code_name, cfg_name)
        checked = dataclasses.replace(cfg, crc=None)  # the kernels run wrapped
        served = [name for name, kernel in (("cuda", cuda_bp), ("cuda_long", cuda_long))
                  if kernel.supported(code, checked, CUDA)]
        assert got == (served[0] if served else "torch"), cfg_name
        if got == "torch":
            for impl in ("cuda", "cuda_long"):
                with pytest.raises(ValueError, match=f"the '{impl}' kernel does not serve"):
                    decoder._implementation(
                        code, dataclasses.replace(cfg, implementation=impl), CUDA)


#: what chip_smoke.py's main paths run on the card today, each on its kernel
MAIN_PATHS = [
    ("wimax576", dict(normalization=0.75, max_iters=40, triage_iters=5), "cuda"),
    ("wimax576", dict(schedule="flooding", self_correction=True), "cuda"),
    ("wimax576", dict(schedule="flooding", algorithm="sum-product"), "cuda"),
    ("wifi1944", dict(normalization=0.75), "cuda"),
    ("rs_ldpc_2048", dict(normalization=0.75, max_iters=20), "cuda"),
    ("nr_bg1_z32", dict(normalization=0.8, max_iters=30), "cuda"),
    ("nr_bg1_z384", dict(normalization=0.8, max_iters=30), "cuda_long"),
    ("nr_bg1_z384", dict(algorithm="sum-product", max_iters=30), "cuda_long"),
    ("nr_bg1_z384", dict(normalization=0.8, soft_output=True), "cuda_long"),
    ("dvbs2_64800", dict(normalization=0.85, max_iters=30, syndrome_mode="lazy"),
     "cuda_long"),
    ("dvbs2_64800", dict(normalization=0.85, soft_output=True), "cuda_long"),
]


@pytest.mark.parametrize("code_name,kw,kernel", MAIN_PATHS)
def test_main_paths_stay_on_their_kernels(modelled_devices, code_name, kw, kernel):
    assert decoder._implementation(_codes(code_name)[1], DecoderConfig(**kw), CUDA) == kernel


def test_torch_route_latches_its_own_check(modelled_devices, monkeypatch):
    """On the card a config that takes the torch path runs its CRC in its
    own latch (ops/bp.py), unwrapped; one on a kernel is wrapped in the
    acceptance retry (ops/crc_accept.py)."""
    monkeypatch.setattr(decoder, "resolve_device", lambda device: CUDA)
    code = _codes("nr_bg1_z384")[1]
    flood = Decoder(code, DecoderConfig(schedule="flooding", crc="24B"), device="cuda")
    assert flood.implementation == "torch"
    assert isinstance(flood._fn, partial) and flood._fn.func is bp.decode_qc
    assert flood._fn.args[1].crc == "24B"
    layered = Decoder(code, DecoderConfig(crc="24B"), device="cuda")
    assert layered.implementation == "cuda_long"
    assert "_make_crc_accept" in layered._fn.__qualname__
    # triage: both passes on the torch path, its check in their latch
    tri = Decoder(code, DecoderConfig(schedule="flooding", self_correction=True,
                                      triage_iters=5, crc="24B"), device="cuda")
    assert tri.implementation == "torch" and "_make_triage" in tri._fn.__qualname__
    passes = [c.cell_contents for c in tri._fn.__closure__
              if isinstance(c.cell_contents, partial)]
    assert len(passes) == 2
    assert all(p.func is bp.decode_qc and p.args[1].crc == "24B" for p in passes)
    assert sorted(p.args[1].max_iters for p in passes) == [5, 40]
    # still refused at construction, as in the reference
    with pytest.raises(ValueError, match="triage"):
        Decoder(code, DecoderConfig(soft_output=True, triage_iters=5), device="cuda")
    with pytest.raises(ValueError, match="self_correction"):
        Decoder(code, DecoderConfig(schedule="flooding", self_correction=True,
                                    implementation="cuda_long"), device="cuda")


@pytest.mark.parametrize("code_name,schedule,warned,impl", [
    ("wimax576", "flooding", None, "cuda"),            # the fused flooding kernel
    ("nr_bg1_z384", "layered", "LAYERED", "cuda_long"),  # the layered substitution
    ("dvbs2_16200", "layered", "LAYERED", "cuda_long"),
    ("nr_bg1_z32", "layered", "LAYERED", "cuda"),      # kernel B's route (TPU: D)
    ("rs_ldpc_8192", "flooding", "no fused kernel", "torch"),  # neither serves
])
def test_resolve_mscl_matches_the_reference(modelled_devices, code_name, schedule,
                                            warned, impl):
    theirs, mine = _codes(code_name)
    with warnings.catch_warnings(record=True) as ref_warned:
        warnings.simplefilter("always")
        want = ref_coder.Coder._resolve_mscl(SimpleNamespace(code=theirs),
                                              ref_coder.DECODE_TYPES["MSCL"])
    with warnings.catch_warnings(record=True) as port_warned:
        warnings.simplefilter("always")
        got = Coder._resolve_mscl(SimpleNamespace(code=mine, device=CUDA),
                                  DECODE_TYPES["MSCL"])
    assert got.schedule == want.schedule == schedule
    assert (got.max_iters, got.algorithm) == (120, "min-sum")
    for caught in (ref_warned, port_warned):
        texts = [str(w.message) for w in caught]
        assert texts == [] if warned is None else (len(texts) == 1 and warned in texts[0])
    if impl == "torch":
        assert "torch flooding path on the card" in str(port_warned[0].message)
    assert decoder._implementation(mine, got, CUDA) == impl
