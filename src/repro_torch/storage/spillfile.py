"""Page checksums and the typed page-corruption error: the port's copy of
the part of ``repro.storage.spillfile`` that checkpoints and the failure
manager use. A checkpoint's COMMIT manifest records its file's checksum
under the algorithm that signed it, so either package verifies the
other's snapshots.

CRC32C (Castagnoli) comes from an accelerated module when the
environment has one; otherwise zlib's C-speed CRC32 (IEEE).
"""
from __future__ import annotations

import zlib

try:                                    # pragma: no cover - env dependent
    from crc32c import crc32c as _crc32c_fn
except ImportError:
    try:                                # pragma: no cover - env dependent
        from google_crc32c import value as _crc32c_fn
    except ImportError:
        _crc32c_fn = None

_ALGO_CRC32C = 1
_ALGO_CRC32 = 2


class PageCorruption(RuntimeError):
    """A page file failed its CRC on fault-in. Typed so the failure
    manager can classify it as recoverable infrastructure damage (the
    fix is a checkpoint restore, not a retry)."""

    def __init__(self, path, detail: str = "checksum mismatch"):
        super().__init__(f"corrupt page {path}: {detail}")
        self.path = str(path)


def page_checksum(buf) -> tuple:
    """(algo, crc) of a page payload under the preferred algorithm."""
    if _crc32c_fn is not None:
        return _ALGO_CRC32C, _crc32c_fn(bytes(buf)) & 0xFFFFFFFF
    return _ALGO_CRC32, zlib.crc32(buf) & 0xFFFFFFFF
