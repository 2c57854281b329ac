"""Table fingerprinting: verifiable drop-in of published standard tables.

NumPy copy of ``myldpccppapi_tpu/codes/tables.py``: the same canonical
hashes, so a table fingerprints identically in both packages.

The shipped NR/DVB-S2 defaults are structure-exact synthetic tables
(PROVENANCE.md): the 3GPP / ETSI publications were not available to the
project, and a from-memory transcription of thousands of constants
risks silent corruption — worse than a documented synthetic.  The loader
:func:`.nr.parse_bg_table` accepts the published formats; THIS module makes
the drop-in verifiable:

* :func:`table_fingerprint` — canonical SHA-256 of a parsed table,
  independent of the source file's formatting (whitespace/CSV/per-set
  layout all fingerprint identically once parsed);
* :func:`register` / :func:`verify` — a name -> fingerprint registry.
  When bit-true tables become available, register their fingerprints once
  (e.g. from a second independent transcription) and every later load is
  checked; until then the registry pins the SHIPPED defaults so a silent
  change to a default table fails loudly.

Reference analogue: the reference embeds its family's constants directly
(``MyLdpc.h:40-102``) and has no integrity story; table corruption there
would surface only as a mysteriously bad BER curve.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple, Union

import numpy as np

__all__ = [
    "table_fingerprint",
    "register",
    "verify",
    "registered",
]

TableLike = Union[np.ndarray, Tuple[Tuple[int, ...], ...]]


def table_fingerprint(table: TableLike) -> str:
    """Canonical SHA-256 hex digest of a parsed table.

    ``np.ndarray`` tables (NR base-graph V arrays, any integer dtype or
    shape) hash shape + int64-normalized values; nested tuples (DVB-S2
    address tables, ragged) hash the canonical decimal text form.  Equal
    tables fingerprint equal regardless of source formatting or dtype.
    """
    h = hashlib.sha256()
    if isinstance(table, np.ndarray):
        arr = np.ascontiguousarray(table.astype(np.int64))
        h.update(b"ndarray")
        h.update(repr(arr.shape).encode())
        h.update(arr.tobytes())
    else:
        h.update(b"rows")
        for row in table:
            h.update((" ".join(str(int(a)) for a in row) + "\n").encode())
    return h.hexdigest()


#: name -> expected fingerprint.  Names follow "<family>_<params>"
#: (e.g. "nr_bg2_z384_base", "dvbs2_16200_1/2_addresses").
_REGISTRY: Dict[str, str] = {}


def register(name: str, fingerprint: str, *, allow_update: bool = False):
    """Register the expected fingerprint for a named table.  Re-registering
    a DIFFERENT fingerprint raises unless ``allow_update`` — changing an
    expected table is a provenance event, not a side effect."""
    old = _REGISTRY.get(name)
    if old is not None and old != fingerprint and not allow_update:
        raise ValueError(
            f"table {name!r} already registered with a different "
            f"fingerprint ({old[:12]}.. vs {fingerprint[:12]}..); pass "
            "allow_update=True if the change is intentional"
        )
    _REGISTRY[name] = fingerprint


def registered(name: str) -> "str | None":
    """The registered fingerprint for ``name`` (None if unregistered)."""
    return _REGISTRY.get(name)


def verify(name: str, table: TableLike, *, strict: bool = False) -> bool:
    """Check ``table`` against the registered fingerprint for ``name``.

    Returns True on match; raises ``ValueError`` on mismatch.  An
    unregistered name returns False (``strict=True`` raises instead) — so
    callers can require verification once real tables are registered.
    """
    expect = _REGISTRY.get(name)
    got = table_fingerprint(table)
    if expect is None:
        if strict:
            raise ValueError(
                f"no fingerprint registered for table {name!r} "
                f"(got {got[:12]}..)"
            )
        return False
    if got != expect:
        raise ValueError(
            f"table {name!r} fingerprint mismatch: expected "
            f"{expect[:16]}.., got {got[:16]}.. — the table data does not "
            "match its registration (transcription error or silent change)"
        )
    return True
