"""TS 38.212 transport-block processing: segmentation, rate matching,
interleaving, and the batched receive chain.

Counterpart of ``myldpccppapi_tpu/codes/nr_transport.py``.  A payload of A
bits gets a TB-level CRC (§7.2.1: CRC24A, or CRC16 for A <= 3824), is
segmented into C code blocks each with its own CRC24B and known-zero
filler bits (§5.2.2), LDPC-encoded per block (§5.3.2), circular-buffer
rate-matched with filler skipping (§5.4.2.1), bit-interleaved by
modulation order (§5.4.2.2), and concatenated (§5.5).

* The planning (:func:`plan_tb`, :func:`select_base_graph`, the §5.2.2
  K_b and lifting-size rules, :class:`TBFormat`) and the circular-buffer
  walk (:func:`_selection_runs`) are NumPy copies of the reference's: all
  per-block structure is resolved to static index runs at plan time, so
  encode and receive are slices, reshapes and one matrix product per CRC
  on the card.
* The C code blocks of a batch of transport blocks decode as one
  ``[B*C, n]`` batch through :class:`~myldpccppapi_torch.Decoder`, with
  CRC24B acceptance at ``crc_span=K'`` (the filler tail excluded).  On the
  card that is the long-code kernel (``csrc/bp_long.cu``) for Z >= 64, or
  the short-code kernel's table route for smaller Z, inside the
  acceptance wrapper (ops/crc_accept.py).
* De-rate-matching adds repeated positions slice by slice in run order,
  never by ``index_add_`` (whose order on CUDA is not fixed).

For payload sizes whose B' is not divisible by C the last code block's
data is zero-padded up to the common K' before its CRC24B; the receiver
truncates the reassembled stream back to A bits.  The base-graph shift
values default to the synthetic girth-6 tables of ``codes/nr.py``; pass
``table=`` for the published ones.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device
from .crc import CRC_POLYS, crc_attach_fn, crc_check_fn
from .nr import NR_LIFTING_SETS, nr_code, rv_start, triangular_encode_fn

__all__ = [
    "TBFormat",
    "TBResult",
    "NRTransport",
    "plan_tb",
    "select_base_graph",
    "interleave_bits",
    "deinterleave_llr",
]

#: §5.2.2 maximum code block size per base graph.
KCB = {1: 8448, 2: 3840}
#: LLR asserted for known-zero filler bits at the receiver (bit 0 => +).
FILLER_LLR = 127.0
#: §7.2.1: transport blocks above this payload size use CRC24A, else CRC16.
TB_CRC16_MAX_A = 3824

_ALL_Z = sorted(z for zs in NR_LIFTING_SETS for z in zs)


def select_base_graph(a: int, rate: float) -> int:
    """TS 38.212 §7.2.2 base-graph selection from payload size and target
    code rate."""
    if a <= 292 or (a <= 3824 and rate <= 0.67) or rate <= 0.25:
        return 2
    return 1


def _kb(bg: int, b: int) -> int:
    """§5.2.2 K_b (the column count used for lifting-size selection)."""
    if bg == 1:
        return 22
    if b > 640:
        return 10
    if b > 560:
        return 9
    if b > 192:
        return 8
    return 6


def _min_lifting(k_min: int, kb: int) -> int:
    for z in _ALL_Z:
        if kb * z >= k_min:
            return z
    raise ValueError(
        f"K'={k_min} exceeds the largest lifting size (K_b={kb}, Zmax=384)"
    )


@dataclasses.dataclass(frozen=True)
class TBFormat:
    """Static plan of one transport-block configuration (hashable).  Build
    with :func:`plan_tb`."""

    a: int                     #: payload bits
    g: int                     #: total rate-matched bits across the TB
    bg: int                    #: base graph (1 or 2)
    qm: int = 1                #: modulation order (bits/symbol) for §5.4.2.2
    nl: int = 1                #: number of transmission layers
    rv: int = 0                #: redundancy version (Table 5.4.2.1-2)
    tb_crc: str = "24A"        #: TB-level CRC name (24A, or 16 for small A)
    cb_crc: Optional[str] = None  #: per-code-block CRC (24B when C > 1)
    c: int = 1                 #: number of code blocks
    k_prime: int = 0           #: bits per code block incl. CB CRC (§5.2.2 K')
    z: int = 0                 #: lifting size Zc
    k: int = 0                 #: info bits per code block (22Z / 10Z)
    f: int = 0                 #: filler bits per code block (K - K')
    pad: int = 0               #: zero-pad bits in the last block's data
    e_r: Tuple[int, ...] = ()  #: rate-matched length per code block

    @property
    def n_cb(self) -> int:
        """Circular-buffer length N (66Z for BG1, 50Z for BG2; no LBRM)."""
        return (66 if self.bg == 1 else 50) * self.z

    @property
    def tb_crc_len(self) -> int:
        return CRC_POLYS[self.tb_crc][0]

    @property
    def cb_crc_len(self) -> int:
        return CRC_POLYS[self.cb_crc][0] if self.cb_crc else 0

    @property
    def b(self) -> int:
        """Payload + TB CRC bits."""
        return self.a + self.tb_crc_len

    @property
    def data_per_block(self) -> int:
        """Data bits per code block (before the CB CRC)."""
        return self.k_prime - self.cb_crc_len

    def describe(self) -> str:
        return (
            f"TB A={self.a} G={self.g} BG{self.bg} Qm={self.qm}: "
            f"C={self.c} K'={self.k_prime} Z={self.z} K={self.k} "
            f"F={self.f} E={sorted(set(self.e_r))}"
        )


def plan_tb(a: int, g: int, *, bg: Optional[int] = None, qm: int = 1,
            nl: int = 1, rv: int = 0,
            rate: Optional[float] = None) -> TBFormat:
    """Resolve the §5.2.2/§5.4.2.1 parameters of one transport block.

    ``a``: payload bits; ``g``: total bits available for its transmission
    (must be a multiple of ``nl * qm``); ``bg`` defaults to the §7.2.2
    selection at code rate ``rate`` (default a/g).
    """
    if a <= 0 or g <= 0:
        raise ValueError("a and g must be positive")
    if g % (nl * qm):
        raise ValueError(f"g={g} must be a multiple of nl*qm={nl * qm}")
    if bg is None:
        bg = select_base_graph(a, a / g if rate is None else rate)
    if bg not in (1, 2):
        raise ValueError(f"bg must be 1 or 2, got {bg}")

    tb_crc = "16" if a <= TB_CRC16_MAX_A else "24A"
    b = a + CRC_POLYS[tb_crc][0]
    kcb = KCB[bg]
    if b <= kcb:
        c, cb_crc, lcb = 1, None, 0
        k_prime = b
    else:
        lcb = 24
        c = math.ceil(b / (kcb - lcb))
        cb_crc = "24B"
        k_prime = math.ceil(b / c) + lcb
    pad = c * (k_prime - lcb) - b
    kb = _kb(bg, b)
    z = _min_lifting(k_prime, kb)
    k = (22 if bg == 1 else 10) * z
    f = k - k_prime

    # §5.4.2.1 per-block rate-matched lengths E_r
    unit = nl * qm
    base = g // (unit * c)
    gamma = (g // unit) % c
    e_r = tuple(
        unit * (base + (1 if r >= c - gamma else 0)) for r in range(c)
    )
    if sum(e_r) != g:
        raise ValueError(f"E_r {e_r} do not add up to g={g}")
    return TBFormat(a=a, g=g, bg=bg, qm=qm, nl=nl, rv=rv, tb_crc=tb_crc,
                    cb_crc=cb_crc, c=c, k_prime=k_prime, z=z, k=k, f=f,
                    pad=pad, e_r=e_r)


# ---------------------------------------------------------------------------
# §5.4.2.2 bit interleaver: f_{i + j*Qm} = e_{i*(E/Qm) + j}
# ---------------------------------------------------------------------------

def interleave_bits(e: torch.Tensor, qm: int) -> torch.Tensor:
    """[..., E] rate-matched bits -> [..., E] interleaved (§5.4.2.2)."""
    if qm == 1:
        return e
    lead, n = e.shape[:-1], e.shape[-1]
    return e.reshape(*lead, qm, n // qm).transpose(-1, -2).reshape(*lead, n)


def deinterleave_llr(f: torch.Tensor, qm: int) -> torch.Tensor:
    """Inverse of :func:`interleave_bits` (applied to received LLRs)."""
    if qm == 1:
        return f
    lead, n = f.shape[:-1], f.shape[-1]
    return f.reshape(*lead, n // qm, qm).transpose(-1, -2).reshape(*lead, n)


# ---------------------------------------------------------------------------
# §5.4.2.1 bit selection as static slice runs
# ---------------------------------------------------------------------------

def _selection_runs(n_cb: int, f_start: int, f_stop: int, k0: int,
                    e: int) -> Tuple[Tuple[int, int], ...]:
    """The circular-buffer walk from ``k0`` skipping filler positions
    [f_start, f_stop), compressed to half-open (start, stop) index runs
    totaling ``e`` positions (NumPy at plan time; encode and receive turn
    each run into one slice)."""
    order = (k0 + np.arange(n_cb)) % n_cb
    keep = (order < f_start) | (order >= f_stop)
    seq = order[keep]
    if seq.size == 0:
        raise ValueError("fillers cover the whole circular buffer")
    reps = -(-e // seq.size)
    seq = np.tile(seq, reps)[:e]
    # compress consecutive +1 increments into runs
    cuts = np.flatnonzero(np.diff(seq) != 1) + 1
    starts = np.concatenate([[0], cuts])
    stops = np.concatenate([cuts, [e]])
    return tuple(
        (int(seq[s]), int(seq[s] + (t - s))) for s, t in zip(starts, stops)
    )


class TBResult(NamedTuple):
    """Decoded transport block plus per-code-block statistics."""

    payload: torch.Tensor     #: [B, A] uint8 decoded payload bits
    tb_ok: torch.Tensor       #: [B] bool: every CB accepted AND TB CRC passes
    tb_crc_ok: torch.Tensor   #: [B] bool: TB-level CRC over the payload
    cb_ok: torch.Tensor       #: [B, C] bool: per-CB acceptance (syndrome+CRC)
    converged: torch.Tensor   #: [B, C] bool: per-CB LDPC syndrome satisfied
    iterations: torch.Tensor  #: [B, C] int32 BP iterations per code block


class NRTransport:
    """Batched TS 38.212 transport-block codec bound to one
    :class:`TBFormat` and one device.

    >>> fmt = plan_tb(a=8448, g=25344, qm=2)
    >>> t = NRTransport(fmt)              # on the card
    >>> tx = t.encode(payload)            # [B, A] 0/1 -> [B, G] int8
    >>> res = t.receive(llr)              # [B, G] float -> TBResult

    ``decoder_config`` defaults to layered normalized min-sum (alpha 0.75)
    with CRC24B acceptance when the TB is segmented.  The device defaults
    to the card and raises without CUDA (``utils/device.py``).
    """

    def __init__(self, fmt: TBFormat, table: Optional[np.ndarray] = None,
                 decoder_config=None, *, device=DEFAULT_DEVICE):
        from ..decoder import Decoder
        from ..utils.config import DecoderConfig

        self.device = resolve_device(device)
        self.fmt = fmt
        self.code = nr_code(fmt.z, fmt.bg, table)
        if self.code.k != fmt.k or self.code.punctured_front != 2 * fmt.z:
            raise ValueError(f"{self.code.name} does not carry {fmt.describe()}")
        if decoder_config is None:
            decoder_config = DecoderConfig(normalization=0.75)
        if fmt.cb_crc and decoder_config.crc is None:
            decoder_config = dataclasses.replace(
                decoder_config, crc=fmt.cb_crc, crc_span=fmt.k_prime
            )
        self.decoder = Decoder(self.code, decoder_config, device=self.device)

        # static plan: per-distinct-E selection runs (fillers are uniform
        # across blocks by construction: the pad lives inside the last
        # block's data)
        k0 = rv_start(self.code, fmt.rv, fmt.n_cb)
        fs = fmt.k_prime - 2 * fmt.z
        fe = fmt.k - 2 * fmt.z
        if fs <= 0:
            raise ValueError("K' <= 2Z: filler range reaches the punctured "
                             "front (unsupported corner)")
        self._runs = {
            e: _selection_runs(fmt.n_cb, fs, fe, k0, e)
            for e in set(fmt.e_r)
        }
        self._filler = (fs, fe)
        self._tb_attach = crc_attach_fn(fmt.a, fmt.tb_crc)
        self._tb_check = crc_check_fn(fmt.a, fmt.tb_crc)
        if fmt.cb_crc:
            self._cb_attach = crc_attach_fn(fmt.data_per_block, fmt.cb_crc)
            self._cb_check = crc_check_fn(fmt.data_per_block, fmt.cb_crc)
        self._encode_cw = triangular_encode_fn(self.code)

    # -- transmit -----------------------------------------------------------

    def segment(self, payload) -> torch.Tensor:
        """[B, A] payload bits -> [B, C, K] code-block info bits (§5.2.2),
        int8 on the transport's device."""
        fmt = self.fmt
        payload = torch.as_tensor(payload, device=self.device)
        if payload.shape[-1] != fmt.a:
            raise ValueError(f"payload must be [..., {fmt.a}]")
        b = payload.shape[0]
        tbb = self._tb_attach(payload.to(torch.int8))  # [B, b]
        if fmt.pad:
            tbb = torch.cat([tbb, tbb.new_zeros((b, fmt.pad))], dim=-1)
        blocks = tbb.reshape(b, fmt.c, fmt.data_per_block)
        if fmt.cb_crc:
            blocks = self._cb_attach(
                blocks.reshape(b * fmt.c, fmt.data_per_block)
            ).reshape(b, fmt.c, fmt.k_prime)
        fill = blocks.new_zeros((b, fmt.c, fmt.f))
        return torch.cat([blocks, fill], dim=-1)  # [B, C, K]

    def encode(self, payload) -> torch.Tensor:
        """[B, A] payload bits -> [B, G] transmitted bits, int8."""
        fmt = self.fmt
        cbs = self.segment(payload)                      # [B, C, K]
        cw = self._encode_cw(cbs)                        # [B, C, n]
        buf = cw[..., 2 * fmt.z:]                        # [B, C, N_cb]
        outs = []
        for r, e in enumerate(fmt.e_r):
            sel = torch.cat(
                [buf[:, r, s:t] for (s, t) in self._runs[e]], dim=-1
            )
            outs.append(interleave_bits(sel, fmt.qm))
        return torch.cat(outs, dim=-1).to(torch.int8)

    # -- receive ------------------------------------------------------------

    def llr_to_blocks(self, llr: torch.Tensor) -> torch.Tensor:
        """[B, G] received LLRs -> [B, C, n] decoder inputs: deinterleave,
        de-rate-match (repeated positions added slice by slice in run
        order), assert the fillers, zero the punctured front."""
        fmt = self.fmt
        if llr.shape[-1] != fmt.g:
            raise ValueError(f"llr must be [..., {fmt.g}]")
        b = llr.shape[0]
        fs, fe = self._filler
        bufs = []
        off = 0
        for e in fmt.e_r:
            seg = deinterleave_llr(llr[:, off:off + e], fmt.qm)
            off += e
            buf = llr.new_zeros((b, fmt.n_cb))
            pos = 0
            for (s, t) in self._runs[e]:
                buf[:, s:t] += seg[:, pos:pos + (t - s)]
                pos += t - s
            buf[:, fs:fe] = FILLER_LLR
            bufs.append(buf)
        buf = torch.stack(bufs, dim=1)                    # [B, C, N_cb]
        front = llr.new_zeros((b, fmt.c, 2 * fmt.z))
        return torch.cat([front, buf], dim=-1)            # [B, C, n]

    def receive(self, llr) -> TBResult:
        """[B, G] received LLRs (positive => bit 0; a tensor or array, moved
        to the transport's device as float32) -> :class:`TBResult`."""
        fmt = self.fmt
        llr = torch.as_tensor(llr, dtype=torch.float32, device=self.device)
        b = llr.shape[0]
        blocks = self.llr_to_blocks(llr).reshape(b * fmt.c, -1)
        res = self.decoder(blocks)
        info = res.bits[:, : fmt.k].reshape(b, fmt.c, fmt.k)
        cb_ok = res.ok.reshape(b, fmt.c)
        if fmt.cb_crc:
            # post-decode CB CRC recheck: keeps cb_ok = syndrome AND CRC24B
            # even under a custom decoder_config without in-loop CRC
            # acceptance (idempotent when the in-loop latch is active)
            cb_bits = info[..., : fmt.k_prime].reshape(b * fmt.c, fmt.k_prime)
            cb_ok = cb_ok & self._cb_check(cb_bits.to(torch.int8)).reshape(b, fmt.c)
        data = info[..., : fmt.data_per_block]            # drop CB CRC+fill
        stream = data.reshape(b, fmt.c * fmt.data_per_block)
        tbb = stream[:, : fmt.b]                          # drop the pad
        tb_crc_ok = self._tb_check(tbb.to(torch.int8))
        return TBResult(
            payload=tbb[:, : fmt.a].to(torch.uint8),
            tb_ok=cb_ok.all(dim=-1) & tb_crc_ok,
            tb_crc_ok=tb_crc_ok,
            cb_ok=cb_ok,
            converged=res.converged.reshape(b, fmt.c),
            iterations=res.iterations.reshape(b, fmt.c),
        )
