"""Byte-stream ``Coder`` facade, API-compatible with the reference C++ library.

Counterpart of ``myldpccppapi_tpu/coder.py``: the arming methods
(``for_encoder`` / ``for_decoder(batch)`` / ``add_decode_type``), the
streaming ``encode`` / ``decode`` over packed byte buffers (LSB-first bit
packing, zero-padded final block), the AWGN self-test ``test``, the size
queries (``MyLdpc.cpp:620-631``), CRC-aided acceptance (``crc=``) and
:func:`make_codec`, which builds a ``Coder`` for every code family of the
port (802.16e, 802.11n, regular, 5G NR, DVB-S2, RS-LDPC).

Decode-type names map onto decoder configurations:

==========  =====================================================
reference    here
==========  =====================================================
DecodeCPU    numpy golden flooding min-sum (ops/golden.py)
DecodeMS     flooding min-sum, plain torch path
DecodeSP     flooding sum-product, plain torch path; the soft stream
             is scaled by 8.0 unless ``llr_scale`` says otherwise
DecodeTDMP   layered min-sum, plain torch path
DecodeMSCL   flooding min-sum, 120 iterations, the short-code CUDA
             kernel on a CUDA device (the reference's fused
             ``decodeOnceMS``); see :meth:`Coder._resolve_mscl`
DecodeTDMPCL layered min-sum, a CUDA kernel on a CUDA device
SCMS         self-corrected flooding min-sum, the CUDA kernel on a
             CUDA device
==========  =====================================================

The reference's ``BF`` (GDBF) raises :class:`NotImplementedError` until its
ROADMAP item is ported.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .codes.encoder import Encoder, encode_numpy
from .codes.wimax import wimax
from .decoder import Decoder
from .ops import cuda_bp, cuda_long, golden
from .ops.channel import awgn, bpsk_modulate
from .ops.packing import pack_bits_np, unpack_bits_np
from .utils.config import DecoderConfig
from .utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["Coder", "DECODE_TYPES", "make_codec"]


def make_codec(family: str, n: int | None = None, rate: str = "1/2", *,
               z: int | None = None, bg: int = 1, max_iters: int = 40,
               crc: str | None = None, device=DEFAULT_DEVICE) -> "Coder":
    """Byte-stream :class:`Coder` for any supported code family
    (``myldpccppapi_tpu/coder.py::make_codec``).

    ==========  ==============================================  ===========
    family       code construction                               encoder
    ==========  ==============================================  ===========
    "wimax"      802.16e, ``n`` in {576..2304}, 6 rate tables    RU matmul
    "wifi"       802.11n, ``n`` in {648, 1296, 1944}, 4 rates    RU matmul
    "regular"    array-construction (3,6), any ``n`` mult. 6     information-set
    "nr"         5G NR BG1/BG2 at lifting ``z``                  triangular back-subst.
    "dvbs2"      EN 302 307 IRA structure, n=64800/16200         accumulator prefix-XOR
    "rs_ldpc"    802.3an-class RS-based, ``n`` = 32 * 2^s        information-set
    ==========  ==============================================  ===========

    The byte-stream semantics (chunking, LSB-first packing, size queries,
    ``test``/``decode``) are the same for every family; 802.16e behaves
    exactly as the reference library (``MyLdpc.cpp:554-618``).
    """
    family = family.lower()
    kw = dict(max_iters=max_iters, crc=crc, device=device)
    if family == "wimax":
        n = n or 576
        code = wimax(n, rate)
        return Coder(code.k, n, rate, **kw)
    if family == "wifi":
        from .codes.wifi import wifi

        return Coder(code=wifi(n or 1296, rate), **kw)
    if family == "regular":
        from .codes.regular import regular

        return Coder(code=regular(n or 648), **kw)
    if family == "nr":
        from .codes.nr import nr_code, triangular_encode_fn, triangular_encode_numpy

        code = nr_code(z=z or 384, bg=bg)
        enc_np = lambda u: triangular_encode_numpy(code, u)  # noqa: E731
        return Coder(code=code, encoders=(enc_np, triangular_encode_fn(code)), **kw)
    if family == "dvbs2":
        from .codes.dvbs2 import dvbs2_ira_qc, ira_encode_fn, ira_encode_numpy

        code = dvbs2_ira_qc(n or 64800, rate)
        enc_np = lambda u: ira_encode_numpy(code, u)  # noqa: E731
        return Coder(code=code, encoders=(enc_np, ira_encode_fn(code)), **kw)
    if family == "rs_ldpc":
        from .codes.rs_ldpc import rs_ldpc_from_n

        if rate != "1/2":
            # the construction fixes the rate (0.841 for n=2048): a caller
            # asking for a specific rate must not silently get another
            raise ValueError(
                "rs_ldpc's rate is fixed by the (gamma, rho) construction "
                "(0.841 at n=2048); omit rate"
            )
        return Coder(code=rs_ldpc_from_n(n or 2048), **kw)
    raise ValueError(
        f"unknown family {family!r}; choose from wimax, wifi, regular, nr, "
        "dvbs2, rs_ldpc"
    )


DECODE_TYPES = {
    "CPU": None,
    "MS": DecoderConfig(algorithm="min-sum", schedule="flooding",
                        implementation="torch"),
    "SP": DecoderConfig(algorithm="sum-product", schedule="flooding",
                        implementation="torch"),
    "TDMP": DecoderConfig(algorithm="min-sum", schedule="layered",
                          implementation="torch"),
    # the fused flooding kernel keeps the reference's own 120-iteration cap
    "MSCL": DecoderConfig(algorithm="min-sum", schedule="flooding",
                          max_iters=120, implementation="auto"),
    "TDMPCL": DecoderConfig(algorithm="min-sum", schedule="layered",
                            implementation="auto"),
    "SCMS": DecoderConfig(algorithm="min-sum", schedule="flooding",
                          self_correction=True, implementation="auto"),
}

#: the reference's decode types still to port, with their ROADMAP items
_NOT_PORTED = {
    "BF": "Queue 1 item 12 (GDBF)",
}
#: the reference's channel scale for sum-product, 2/sigma^2 at sigma^2 =
#: 0.25 (decodeCL.c:9): min-sum is scale-invariant, sum-product is not
_SP_LLR_SCALE = 8.0


class Coder:
    """Byte-stream LDPC codec on one device.

    ``Coder(k, n, rate)`` is the reference-compatible 802.16e constructor
    (``rate`` in "1/2", "2/3A", "2/3B", "3/4A", "3/4B", "5/6"); any other
    code comes in as ``code=`` (:func:`make_codec` picks each family's
    encoder).  ``encoders`` is an optional ``(numpy_fn, torch_fn)`` pair,
    info bits [ncw, k_info] -> codeword [ncw, n] (the NR triangular and
    DVB-S2 IRA encoders); without it the code's own information-set
    precompute, the generic one or RU's.  Encoding, the channel noise of
    :meth:`test` and the decoders run on ``device``, the card unless
    ``device="cpu"``; ``msg_dtype`` ("float32" or "bfloat16") is the
    message type of every decode type but the golden ``CPU`` one.

    Streaming contract: the byte stream is chunked into ``k_info // 8``
    bytes per codeword (trailing info bits of a non-byte-aligned k, e.g.
    802.11n n=648 rate 1/2, k=324, are always zero).  With ``crc`` set,
    the last L info bits carry the CRC (TS 38.212 §5.1 code-block layout):
    ``encode`` attaches it, payload chunking shrinks to ``(k_info - L) //
    8`` bytes per codeword, and ``decode`` requires syndrome AND CRC for
    acceptance (its stats report ``accepted`` and ``crc_rejected``).
    """

    def __init__(self, ldpc_k: int | None = None, ldpc_n: int | None = None,
                 rate: str | None = None, max_iters: int = 40, *,
                 code=None, encoders=None, crc: str | None = None,
                 device=DEFAULT_DEVICE, msg_dtype: str = "float32"):
        if code is None:
            code = wimax(ldpc_n, rate)
            if code.k != ldpc_k:
                raise ValueError(
                    f"k={ldpc_k} inconsistent with n={ldpc_n} rate={rate} "
                    f"(expected k={code.k})"
                )
        self.code = code
        self.device = resolve_device(device)
        self._custom_encoders = encoders
        self.crc = crc
        self._crc_len = 0
        if crc is not None:
            from .codes.crc import CRC_POLYS

            if crc not in CRC_POLYS:
                raise ValueError(
                    f"unknown crc {crc!r}; choose from {sorted(CRC_POLYS)}"
                )
            self._crc_len = CRC_POLYS[crc][0]
            if self.code.k_info <= self._crc_len + 8:
                raise ValueError(
                    f"CRC{crc} leaves no payload in k_info={self.code.k_info}"
                )
        self._kb = (self.code.k_info - self._crc_len) // 8
        self.max_iters = max_iters
        self.msg_dtype = msg_dtype
        self._encoder: Encoder | None = None
        self._encode_np = None
        self._encode_torch = None
        self._decoders: dict[str, Decoder] = {}
        self.batch_size = 0

    # -- arming ------------------------------------------------------------
    def for_encoder(self) -> None:
        if self._custom_encoders is not None:
            self._encode_np, self._encode_torch = self._custom_encoders
        else:
            self._encoder = Encoder(self.code, device=self.device)

    def for_decoder(self, batch_size: int) -> None:
        self.batch_size = int(batch_size)

    def add_decode_type(self, de_type: str) -> None:
        if de_type in _NOT_PORTED:
            raise NotImplementedError(
                f"decode type {de_type!r} is not ported to the PyTorch "
                f"package yet (ROADMAP {_NOT_PORTED[de_type]})"
            )
        if de_type not in DECODE_TYPES:
            raise ValueError(f"unknown decode type {de_type!r}; choose from "
                             f"{sorted(DECODE_TYPES)}")
        if de_type == "CPU":
            return
        cfg = dataclasses.replace(DECODE_TYPES[de_type], msg_dtype=self.msg_dtype)
        if de_type != "MSCL":  # MSCL keeps its own iteration cap
            cfg = dataclasses.replace(cfg, max_iters=self.max_iters)
        else:
            cfg = self._resolve_mscl(cfg)
        if self.crc is not None:
            cfg = dataclasses.replace(cfg, crc=self.crc)
        self._decoders[de_type] = Decoder(self.code, cfg, device=self.device)

    def _resolve_mscl(self, cfg: DecoderConfig) -> DecoderConfig:
        """MSCL names the reference's FUSED flooding min-sum kernel
        (``decodeOnceMS``, ``decodeCL.c:432-567``): the whole decode in one
        kernel (``myldpccppapi_tpu/coder.py::_resolve_mscl``).  On the card
        it keeps flooding where the short-code kernel serves it; where it
        does not (its flooding state exceeds a thread block) and the
        long-code kernel serves the layered schedule, it substitutes the
        layered schedule (same min-sum arithmetic, fewer iterations to
        converge) and says so.  Where neither serves, it returns ``cfg``
        and ``Decoder`` raises: the reference decodes there on its jnp
        flooding path, the port falls back to no plain path (ROADMAP,
        divergences by rule).  On the CPU every decode type runs the torch
        path, so ``cfg`` comes back unchanged."""
        if self.device.type != "cuda":
            return cfg
        if cuda_bp.supported(self.code, cfg, self.device):
            return cfg
        layered = dataclasses.replace(cfg, schedule="layered")
        if cuda_long.supported(self.code, layered, self.device):
            warnings.warn(
                f"MSCL on {self.code.name} (n={self.code.n}): the fused "
                "flooding kernel cannot hold this code, so the fused contract "
                "is served by the LAYERED long-code kernel instead: same "
                "min-sum arithmetic, fewer iterations to converge.  Use "
                'decode type "MS" for exact flooding semantics (torch path).',
                stacklevel=3,
            )
            return layered
        return cfg

    # -- size queries (same rounding contract as MyLdpc.cpp:620-631) -------
    def get_code_size(self, src_length: int) -> int:
        kb = self._kb
        return (src_length + kb - 1) // kb

    def get_prior_code_length(self, src_length: int) -> int:
        return self.get_code_size(src_length) * (self.code.n // 8)

    def get_post_code_length(self, src_length: int) -> int:
        return self.get_code_size(src_length) * self.code.n

    # -- streaming ----------------------------------------------------------
    def encode(self, src: bytes | np.ndarray) -> np.ndarray:
        """Packed source bytes -> packed codeword bytes (uint8 array).

        The stream is chunked into k/8-byte blocks; the final partial block
        is zero-padded (reference: ``MyLdpc.cpp:554-569,661-662``).
        """
        if self._encoder is None and self._encode_np is None:
            raise RuntimeError("call for_encoder() first")
        if isinstance(src, (bytes, bytearray)):
            src = np.frombuffer(bytes(src), dtype=np.uint8)
        src = np.asarray(src, dtype=np.uint8)
        kb = self._kb
        ncw = self.get_code_size(len(src))
        padded = np.zeros(ncw * kb, dtype=np.uint8)
        padded[: len(src)] = src
        info_bits = unpack_bits_np(padded.reshape(ncw, kb))  # [ncw, kb*8]
        k_msg = self.code.k_info - self._crc_len
        if k_msg > kb * 8:  # non-byte-aligned k: trailing message bits are 0
            info_bits = np.concatenate(
                [info_bits,
                 np.zeros((ncw, k_msg - kb * 8), dtype=info_bits.dtype)],
                axis=1,
            )
        if self.crc is not None:
            # attach the CRC field (last L info bits, 38.212 layout)
            from .codes.crc import crc_matrix

            par = (info_bits.astype(np.int64)
                   @ crc_matrix(k_msg, self.crc).astype(np.int64)) & 1
            info_bits = np.concatenate(
                [info_bits, par.astype(info_bits.dtype)], axis=1
            )
        if self._encode_np is not None:
            if ncw < 256 or self._encode_torch is None:
                cw = np.asarray(self._encode_np(info_bits))
            else:
                cw = self._encode_torch(
                    torch.as_tensor(info_bits, device=self.device)).cpu().numpy()
        elif ncw < 256:
            # small streams: the host matmul beats a device round trip
            cw = encode_numpy(self._encoder.mats, info_bits)
        else:
            cw = self._encoder(torch.as_tensor(info_bits)).cpu().numpy()
        return pack_bits_np(cw.astype(np.uint8)).reshape(-1)

    def test(self, prior_code: np.ndarray, sigma: float, seed: int = 0) -> np.ndarray:
        """BPSK + AWGN over a packed codeword stream -> soft values [len*8].

        Matches ``Coder::test`` (``MyLdpc.cpp:1061-1078``): bit 1 -> -1.0,
        bit 0 -> +1.0, Gaussian noise of std ``sigma`` from a
        ``torch.Generator`` seeded with ``seed`` on the coder's device.
        """
        bits = unpack_bits_np(np.asarray(prior_code, dtype=np.uint8))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        sym = bpsk_modulate(torch.as_tensor(bits, device=self.device))
        return awgn(gen, sym, sigma).cpu().numpy()

    def decode(
        self,
        post_code: np.ndarray,
        src_length: int,
        de_type: str = "TDMP",
        llr_scale: float | None = None,
        return_stats: bool = False,
    ):
        """Soft stream [ncw*n] -> decoded source bytes [src_length].

        Like the reference, the raw channel value is fed to min-sum as the
        LLR (min-sum is scale-invariant); ``llr_scale`` multiplies it.  For
        ``SP`` it defaults to the reference's 8.0 = 2/sigma^2 at sigma^2 =
        0.25; pass a calibrated ``2 / sigma**2`` instead.
        """
        if src_length == 0:
            decoded = np.zeros(0, dtype=np.uint8)
            if return_stats:
                return decoded, {"converged": np.zeros(0, bool),
                                 "iterations": np.zeros(0, np.int32),
                                 "mean_iters": 0.0}
            return decoded
        # a private copy: the stream may be a read-only array
        post = np.array(post_code, dtype=np.float32).reshape(-1, self.code.n)
        if llr_scale is None:
            llr_scale = _SP_LLR_SCALE if de_type == "SP" else 1.0
        if llr_scale != 1.0:
            post = post * np.float32(llr_scale)
        ncw = self.get_code_size(src_length)
        if post.shape[0] != ncw:
            raise ValueError(f"expected {ncw} codewords, got {post.shape[0]}")
        accepted = None
        if de_type == "CPU":
            bits, conv, iters = golden.decode_golden(
                self.code, post, max_iters=self.max_iters)
            if self.crc is not None:
                # the golden decoder has no in-loop CRC; acceptance is the
                # post-hoc syndrome AND CRC (no continuation)
                accepted = conv & self._crc_ok_np(bits)
        else:
            if de_type not in self._decoders:
                self.add_decode_type(de_type)
            dec = self._decoders[de_type]
            batch = self.batch_size or ncw
            outs, convs, iterss, accs = [], [], [], []
            for off in range(0, ncw, batch):
                res = dec(torch.as_tensor(post[off: off + batch]))
                outs.append(res.bits.cpu().numpy())
                convs.append(res.converged.cpu().numpy())
                iterss.append(res.iterations.cpu().numpy())
                accs.append(res.ok.cpu().numpy())
            bits = np.concatenate(outs, axis=0)
            conv = np.concatenate(convs)
            iters = np.concatenate(iterss)
            if self.crc is not None:
                accepted = np.concatenate(accs)
        pos = np.asarray(self.code.info_positions)[: self._kb * 8]
        decoded = pack_bits_np(bits[:, pos]).reshape(-1)[:src_length]
        if return_stats:
            # per-codeword convergence + iteration counts (the reference
            # prints "Time=<iters>" per batch, MyLdpc.cpp:838,966,1048)
            stats = {
                "converged": conv,
                "iterations": iters,
                "mean_iters": float(np.mean(iters)),
            }
            if accepted is not None:
                stats["accepted"] = accepted
                stats["crc_rejected"] = int(np.sum(conv & ~accepted))
            return decoded, stats
        return decoded

    def _crc_ok_np(self, bits: np.ndarray) -> np.ndarray:
        """[ncw, n] hard bits -> bool[ncw] CRC consistency over the info
        block (numpy, for the CPU golden path)."""
        from .codes.crc import crc_matrix

        k_info = self.code.k_info
        k_msg = k_info - self._crc_len
        info = bits[:, np.asarray(self.code.info_positions)].astype(np.int64)
        par = (info[:, :k_msg] @ crc_matrix(k_msg, self.crc).astype(np.int64)) & 1
        return (par == info[:, k_msg:k_info]).all(axis=1)
