"""mmap-backed on-disk page layouts (the spill tier under the pager) — the
port's copy of ``repro.storage.spillfile``. The bytes on disk are the
reference's (npy payload + the same CRC trailer), so each package reads
the other's pages and checkpoints.

Each page spills to its own ``.npy`` file written through
``numpy.lib.format.open_memmap`` — the array bytes land contiguously
after the npy header, so a page write-back or fault-in is one sequential
I/O pass (GraphD's discipline: out-of-core graph state must stream, not
seek; arXiv 1601.05590). The Vertex relation slices and the
run-structured host inbox (the ``(P_dst, P_src, C)`` run buffers of
``core/ooc.py``) both serialize contiguously, which is what makes inbox
spill and reload sequential.

Writes are ATOMIC: data goes to a temp file in the same directory and is
``os.replace``d over the page file. That makes hard links safe in both
directions — a checkpoint can ``os.link`` a page file instead of copying
it (``export_to``) and a resume can ``os.link`` checkpoint pages into a
new spill directory (``adopt``): a later write-back replaces the
directory entry rather than scribbling on the shared inode, so the
checkpoint stays immutable for free.

Writes are also CHECKSUMMED: a 12-byte trailer (magic + checksum algo +
CRC32C of the array bytes) is appended after the npy payload — ``np.load``
ignores trailing bytes, so the file stays a valid ``.npy``. ``load``
recomputes the CRC on every fault-in and raises the typed
``PageCorruption`` on mismatch; the recovery supervisor treats that as
recoverable (restore from the last valid checkpoint), and checkpoint
verification walks the same trailers to reject corrupt snapshots.
Hard-linked checkpoint exports carry the trailer for free.

Both ``store`` and ``load`` are chaos-harness sites (``spill.write`` /
``spill.read`` / ``page.corrupt`` — see ``repro_torch.runtime.faults``).
"""
from __future__ import annotations

import os
import re
import shutil
import struct
import threading
import zlib
from pathlib import Path

import numpy as np

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")

# -- page checksums ------------------------------------------------------
# CRC32C (Castagnoli) via the accelerated module when the environment has
# one; otherwise zlib's C-speed CRC32 (IEEE). The trailer records which
# algorithm signed the page, so verification always uses the right one —
# a pure-Python CRC32C over multi-MiB pages would tax every fault-in.
try:                                    # pragma: no cover - env dependent
    from crc32c import crc32c as _crc32c_fn
except ImportError:
    try:                                # pragma: no cover - env dependent
        from google_crc32c import value as _crc32c_fn
    except ImportError:
        _crc32c_fn = None

_ALGO_CRC32C = 1
_ALGO_CRC32 = 2
_TRAILER = struct.Struct("<4sBB2xI")    # magic, version, algo, pad, crc
_MAGIC = b"PGXC"
TRAILER_BYTES = _TRAILER.size


class PageCorruption(RuntimeError):
    """A page file failed its CRC on fault-in. Typed so the failure
    manager can classify it as recoverable infrastructure damage (the
    fix is a checkpoint restore, not a retry — re-reading corrupt bytes
    returns the same corrupt bytes)."""

    def __init__(self, path, detail: str = "checksum mismatch"):
        super().__init__(f"corrupt page {path}: {detail}")
        self.path = str(path)


def page_checksum(buf) -> tuple:
    """(algo, crc) of a page payload under the preferred algorithm."""
    if _crc32c_fn is not None:
        return _ALGO_CRC32C, _crc32c_fn(bytes(buf)) & 0xFFFFFFFF
    return _ALGO_CRC32, zlib.crc32(buf) & 0xFFFFFFFF


def _checksum_with(algo: int, buf):
    if algo == _ALGO_CRC32C and _crc32c_fn is not None:
        return _crc32c_fn(bytes(buf)) & 0xFFFFFFFF
    if algo == _ALGO_CRC32:
        return zlib.crc32(buf) & 0xFFFFFFFF
    return None                          # unverifiable in this env


def read_trailer(path) -> tuple:
    """(algo, crc) from a page file's trailer, or (None, None) when the
    file predates checksumming (legacy pages stay loadable)."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size < TRAILER_BYTES:
                return None, None
            f.seek(size - TRAILER_BYTES)
            raw = f.read(TRAILER_BYTES)
    except OSError:
        return None, None
    magic, _ver, algo, crc = _TRAILER.unpack(raw)
    if magic != _MAGIC:
        return None, None
    return algo, crc


def verify_page_file(path) -> bool:
    """Recompute a page file's CRC against its trailer (checkpoint
    verification). True when it matches or the file has no trailer /
    the algo is unavailable here; False on mismatch or unreadable npy."""
    algo, want = read_trailer(path)
    if algo is None:
        return True
    try:
        mm = np.load(path, mmap_mode="r")
    except (OSError, ValueError):
        return False
    try:
        got = _checksum_with(algo, _payload_view(mm))
    finally:
        del mm
    return got is None or got == want


def _payload_view(mm: np.ndarray):
    """The page's data bytes as a flat buffer (what the CRC covers)."""
    return memoryview(np.ascontiguousarray(mm)).cast("B")


def _faults():
    from repro_torch.runtime import faults
    return faults


def _key_filename(key) -> str:
    parts = key if isinstance(key, tuple) else (key,)
    return _SAFE.sub("-", "_".join(str(p) for p in parts)) + ".npy"


class SpillSlot:
    """One page's on-disk home: a single ``.npy`` file (+ CRC trailer)."""

    def __init__(self, path):
        self.path = Path(path)

    def exists(self) -> bool:
        return self.path.exists()

    def store(self, arr: np.ndarray):
        """Sequential, atomic, checksummed write-back of the whole page.
        The temp file is thread-unique so a background I/O-engine drain
        and a foreground flush can never collide on it."""
        faults = _faults()
        faults.hit("spill.write", str(self.path.name))
        tmp = self.path.with_name(
            f".{self.path.name}.{threading.get_ident()}.tmp")
        mm = np.lib.format.open_memmap(tmp, mode="w+", dtype=arr.dtype,
                                       shape=arr.shape)
        mm[...] = arr
        mm.flush()
        algo, crc = page_checksum(_payload_view(mm))
        del mm
        with open(tmp, "ab") as f:
            f.write(_TRAILER.pack(_MAGIC, 1, algo, crc))
        if faults.corrupt("page.corrupt", str(self.path.name)):
            # Damage a payload byte AFTER the trailer was signed — the
            # next fault-in's CRC check must catch it.
            with open(tmp, "r+b") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() > TRAILER_BYTES + 1:
                    f.seek(-(TRAILER_BYTES + 1), os.SEEK_END)
                    b = f.read(1)
                    f.seek(-1, os.SEEK_CUR)
                    f.write(bytes([b[0] ^ 0xFF]))
        os.replace(tmp, self.path)

    def load(self) -> np.ndarray:
        """Fault the page back in (one sequential read of the mmap) and
        verify its CRC trailer; raises PageCorruption on mismatch."""
        _faults().hit("spill.read", str(self.path.name))
        algo, want = read_trailer(self.path)
        try:
            mm = np.load(self.path, mmap_mode="r")
        except ValueError as e:
            # damage reached the npy header itself
            raise PageCorruption(self.path, f"unreadable npy ({e})")
        out = np.array(mm)
        del mm
        if algo is not None:
            got = _checksum_with(algo, _payload_view(out))
            if got is not None and got != want:
                raise PageCorruption(self.path)
        return out

    def delete(self):
        try:
            self.path.unlink()
        except FileNotFoundError:
            pass

    def export_to(self, dst, *, allow_link: bool = True):
        """Publish this page file at ``dst`` without a DRAM round-trip:
        hard-link when the filesystem allows it, else a kernel-side file
        copy. Atomic write-backs make the link safe (see module doc)."""
        dst = Path(dst)
        if allow_link:
            try:
                os.link(self.path, dst)
                return
            except OSError:
                pass
        shutil.copyfile(self.path, dst)

    def adopt(self, src, *, allow_link: bool = True):
        """Populate this slot from an existing page file (resume path)."""
        src = Path(src)
        self.delete()
        if allow_link:
            try:
                os.link(src, self.path)
                return
            except OSError:
                pass
        shutil.copyfile(src, self.path)


class SpillDir:
    """A directory of page files, one slot per page key."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def slot_for(self, key) -> SpillSlot:
        return SpillSlot(self.root / _key_filename(key))

    def bytes_on_disk(self) -> int:
        """Bytes currently occupying the SSD tier (every page file in
        the directory). A directory walk, so only sampled at superstep
        boundaries (``obs.memwatch``); temp files
        mid-``replace`` are skipped."""
        total = 0
        try:
            with os.scandir(self.root) as it:
                for e in it:
                    if e.name.endswith(".npy") and e.is_file():
                        try:
                            total += e.stat().st_size
                        except OSError:
                            pass
        except OSError:
            pass
        return total
