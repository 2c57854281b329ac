"""Byte-stream ``Coder`` facade, API-compatible with the reference C++ library.

Counterpart of ``myldpccppapi_tpu/coder.py`` for the 802.16e codes: the
arming methods (``for_encoder`` / ``for_decoder(batch)`` /
``add_decode_type``), the streaming ``encode`` / ``decode`` over packed
byte buffers (LSB-first bit packing, zero-padded final block), the AWGN
self-test ``test``, and the size queries (``MyLdpc.cpp:620-631``).

Decode-type names map onto decoder configurations:

==========  =====================================================
reference    here
==========  =====================================================
DecodeCPU    numpy golden flooding min-sum (ops/golden.py)
DecodeMS     flooding min-sum, plain torch path
DecodeSP     flooding sum-product, plain torch path; the soft stream
             is scaled by 8.0 unless ``llr_scale`` says otherwise
DecodeTDMP   layered min-sum, plain torch path
DecodeMSCL   flooding min-sum, 120 iterations, the CUDA kernel on a
             CUDA device (the reference's fused ``decodeOnceMS``)
DecodeTDMPCL layered min-sum, the CUDA kernel on a CUDA device
SCMS         self-corrected flooding min-sum, the CUDA kernel on a
             CUDA device
==========  =====================================================

The reference's ``BF`` (GDBF) raises :class:`NotImplementedError` until its
ROADMAP item is ported.  The reference substitutes the layered schedule for
``MSCL`` where its fused flooding kernel cannot hold a code
(``myldpccppapi_tpu/coder.py::_resolve_mscl``); every 802.16e code fits the
short-code kernel's flooding state, so for this 802.16e ``Coder`` that
substitution never fires and ``MSCL`` always decodes by flooding.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .codes.encoder import Encoder, encode_numpy
from .codes.wimax import wimax
from .decoder import Decoder
from .ops import golden
from .ops.channel import awgn, bpsk_modulate
from .ops.packing import pack_bits_np, unpack_bits_np
from .utils.config import DecoderConfig
from .utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["Coder", "DECODE_TYPES"]

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
    """Byte-stream 802.16e LDPC codec on one device.

    ``Coder(k, n, rate)`` is the reference-compatible constructor (``rate``
    in "1/2", "2/3A", "2/3B", "3/4A", "3/4B", "5/6").  The byte stream is
    chunked into ``k // 8`` bytes per codeword.  Encoding, the channel
    noise of :meth:`test` and the decoders run on ``device``, the card
    unless ``device="cpu"``.
    """

    def __init__(self, ldpc_k: int, ldpc_n: int, rate: str,
                 max_iters: int = 40, *, device=DEFAULT_DEVICE):
        code = wimax(ldpc_n, rate)
        if code.k != ldpc_k:
            raise ValueError(
                f"k={ldpc_k} inconsistent with n={ldpc_n} rate={rate} "
                f"(expected k={code.k})"
            )
        self.code = code
        self.device = resolve_device(device)
        self._kb = self.code.k_info // 8
        self.max_iters = max_iters
        self._encoder: Encoder | None = None
        self._decoders: dict[str, Decoder] = {}
        self.batch_size = 0

    # -- arming ------------------------------------------------------------
    def for_encoder(self) -> None:
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
        cfg = DECODE_TYPES[de_type]
        if de_type != "MSCL":  # MSCL keeps its own iteration cap
            cfg = dataclasses.replace(cfg, max_iters=self.max_iters)
        self._decoders[de_type] = Decoder(self.code, cfg, device=self.device)

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
        if self._encoder is None:
            raise RuntimeError("call for_encoder() first")
        if isinstance(src, (bytes, bytearray)):
            src = np.frombuffer(bytes(src), dtype=np.uint8)
        src = np.asarray(src, dtype=np.uint8)
        kb = self._kb
        ncw = self.get_code_size(len(src))
        padded = np.zeros(ncw * kb, dtype=np.uint8)
        padded[: len(src)] = src
        info_bits = unpack_bits_np(padded.reshape(ncw, kb))  # [ncw, k]
        if ncw < 256:
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
        if de_type == "CPU":
            bits, conv, iters = golden.decode_golden(
                self.code, post, max_iters=self.max_iters)
        else:
            if de_type not in self._decoders:
                self.add_decode_type(de_type)
            dec = self._decoders[de_type]
            batch = self.batch_size or ncw
            outs, convs, iterss = [], [], []
            for off in range(0, ncw, batch):
                res = dec(torch.as_tensor(post[off: off + batch]))
                outs.append(res.bits.cpu().numpy())
                convs.append(res.converged.cpu().numpy())
                iterss.append(res.iterations.cpu().numpy())
            bits = np.concatenate(outs, axis=0)
            conv = np.concatenate(convs)
            iters = np.concatenate(iterss)
        pos = np.asarray(self.code.info_positions)[: self._kb * 8]
        decoded = pack_bits_np(bits[:, pos]).reshape(-1)[:src_length]
        if return_stats:
            # per-codeword convergence + iteration counts (the reference
            # prints "Time=<iters>" per batch, MyLdpc.cpp:838,966,1048)
            return decoded, {
                "converged": conv,
                "iterations": iters,
                "mean_iters": float(np.mean(iters)),
            }
        return decoded
