"""Carry state across from the JAX package (``myldpccppapi_tpu``).

Each function duck-types on the reference object's NumPy attributes and
returns the port's own object, so both packages can compute on the same
code, configuration, encoder and constellation.  Nothing here imports the
reference.
"""
from __future__ import annotations

import numpy as np

from .codes.dvbs2 import DVBS2Code
from .codes.encoder import EncoderMatrices
from .codes.qc import QCCode
from .codes.rs_ldpc import RSLDPCCode
from .ops.modulation import Modulation
from .utils.config import DecoderConfig

__all__ = ["code_from_reference", "config_from_reference",
           "encoder_from_reference", "modulation_from_reference"]

#: reference implementation names -> the port's
IMPLEMENTATION_NAMES = {
    "auto": "auto",
    "jnp": "torch",
    "pallas": "cuda",
    "pallas_zlane": "cuda_long",
    "edgelist": "edgelist",
}


def code_from_reference(obj) -> "QCCode | RSLDPCCode | DVBS2Code":
    """A reference ``QCCode`` (name, base, z and the optional structure
    fields) -> the port's :class:`QCCode`; a reference ``RSLDPCCode`` (the
    xor group: name, s, shifts) -> the port's :class:`RSLDPCCode`; a
    reference ``DVBS2Code`` (the standard-domain oracle: name, n, k,
    addresses) -> the port's :class:`DVBS2Code`."""
    if hasattr(obj, "addresses") and not hasattr(obj, "blocks"):
        return DVBS2Code(name=obj.name, n=int(obj.n), k=int(obj.k),
                         addresses=tuple(tuple(int(a) for a in g)
                                         for g in obj.addresses))
    if getattr(obj, "group", "cyclic") == "xor":
        return RSLDPCCode(name=obj.name, s=int(obj.s),
                          shifts=np.array(obj.shifts, dtype=np.int64))
    info_cols = getattr(obj, "info_cols", None)
    return QCCode(
        name=obj.name,
        base=np.array(obj.base, dtype=np.int32),
        z=int(obj.z),
        punctured_front=int(getattr(obj, "punctured_front", 0)),
        info_cols=None if info_cols is None else np.array(info_cols),
        extra_blocks=getattr(obj, "extra_blocks", None),
        masked_rows=getattr(obj, "masked_rows", None),
    )


def config_from_reference(cfg) -> DecoderConfig:
    """A reference ``DecoderConfig`` -> the port's, field by field (the
    schedule, algorithm, weights, SCMS and soft-output fields included),
    with the implementation name mapped (jnp -> torch, pallas -> cuda,
    pallas_zlane -> cuda_long).  Fields the port does not serve yet raise
    as the port's DecoderConfig does."""
    fields = {f.name: getattr(cfg, f.name)
              for f in DecoderConfig.__dataclass_fields__.values()}
    impl = fields["implementation"]
    if impl not in IMPLEMENTATION_NAMES:
        raise ValueError(f"reference implementation {impl!r} has no "
                         "counterpart in the port")
    fields["implementation"] = IMPLEMENTATION_NAMES[impl]
    return DecoderConfig(**fields)


def encoder_from_reference(mats) -> EncoderMatrices:
    """Reference ``EncoderMatrices`` (w, gap, perm) -> the port's."""
    perm = getattr(mats, "perm", None)
    return EncoderMatrices(
        w=np.array(mats.w, dtype=np.bool_),
        gap=int(mats.gap),
        perm=None if perm is None else np.array(perm, dtype=np.int64),
    )


def modulation_from_reference(mod) -> Modulation:
    """A reference ``Modulation`` (name, points, labels and the optional
    per-axis PAM alphabet) -> the port's, so a caller's normative label
    table goes through both packages alike."""
    pam = getattr(mod, "pam", None)
    return Modulation(
        name=mod.name,
        points=np.array(mod.points, dtype=np.complex64),
        labels=np.array(mod.labels, dtype=np.uint8),
        pam=None if pam is None else (np.array(pam[0], dtype=np.float32),
                                      np.array(pam[1], dtype=np.uint8)),
    )
