"""TieredStore — the HBM ↔ DRAM ↔ disk facade the OOC driver runs on
(the port's copy of ``repro.storage.tiered``).

``core/ooc.py``'s dispatcher/collector reads and writes its host state
through this facade: the buffer cache (``storage.pager``) sits between
them and the spill tier (``storage.spillfile``), extending the memory
hierarchy by one level:

    prefetch:  disk ──(page fault)──▶ DRAM ──(pinned staging,
               copy stream)──▶ HBM
    commit:    HBM ──(copy stream, pinned buffer)──▶ DRAM ──(lazy
               write-back)──▶ disk

The store holds numpy pages only; the driver does every device copy.

Relations are chunked one page per (relation, super-partition) — exactly
the granularity the streaming executor touches — so the pipeline's
existing overlap discipline hides the disk leg the same way it hides the
host link. Dynamic pages (run-structured inbox generations, collected
out-blocks, mutation blocks) share the same pool and budget via the raw
``put_page``/``get_page`` API.

When ``io_threads > 0`` (and a disk dir is configured) the store owns a
background page-I/O engine (``storage.io_engine``): ``readahead(keys)``
schedules the next dispatchable destination's page faults off the
critical path, and every readahead tick also drains cold dirty pages
(write coalescing, eviction-order targeting) so foreground evictions
find clean victims. ``flush`` drains the engine before the synchronous
write-back pass, and ``close`` shuts it down with the dirty queue
drained — see the engine's module docstring for the locking/pin rules.

With ``disk_dir=None`` and no budget the store degenerates to the pure
DRAM tier (every page stays resident; zero I/O) — the disk tier is a
strictly additive layer, which is what makes the disk-vs-DRAM parity
suite bit-for-bit (``tests/test_torch_storage.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.storage.pager import BufferPool
from repro_torch.storage.spillfile import SpillDir, SpillSlot


class TieredStore:
    """Named, super-partition-chunked relations over a ``BufferPool``."""

    def __init__(self, *, n_sp: int, budget_bytes: Optional[int] = None,
                 disk_dir: Optional[str] = None, policy: str = "lru",
                 io_threads: int = 0, readahead_pages: int = 8,
                 metrics=None):
        self.n_sp = int(n_sp)
        self.spill = SpillDir(disk_dir) if disk_dir else None
        self.pool = BufferPool(budget_bytes, policy=policy,
                               spill=self.spill)
        self.engine = None
        if io_threads > 0 and self.spill is not None:
            from repro_torch.storage.io_engine import IOEngine
            self.engine = IOEngine(self.pool, threads=io_threads,
                                   readahead_pages=readahead_pages,
                                   metrics=metrics)
            self.pool.attach_engine(self.engine)
        self._relations: dict = {}   # name -> per-chunk row counts

    @property
    def spilling(self) -> bool:
        return self.spill is not None

    # ---- relations (chunked on the leading partition axis) -----------
    def register(self, name: str, arr: np.ndarray):
        """Split a (P, ...) relation into n_sp pages. The chunks copy out
        of ``arr`` so the source can be freed immediately."""
        arr = np.asarray(arr)
        P = arr.shape[0]
        assert P % self.n_sp == 0, (name, P, self.n_sp)
        sp = P // self.n_sp
        self._relations[name] = sp
        for s in range(self.n_sp):
            self.pool.put((name, s), arr[s * sp:(s + 1) * sp])

    def read(self, name: str, s: int) -> np.ndarray:
        """Chunk ``s`` of a relation (page fault from disk on a miss).
        The array is the cached buffer — treat it as read-only."""
        return self.pool.get((name, s))

    def write(self, name: str, s: int, arr: np.ndarray):
        """Full-chunk replacement (the ``inplace`` write-back policy):
        dirties the page; the disk write happens lazily on eviction."""
        self.pool.put((name, s), arr)

    def write_rows(self, name: str, s: int, mask: np.ndarray,
                   rows: np.ndarray):
        """Scatter-merge changed rows into a chunk (the ``delta`` /
        LSM-deferred-merge policy). A chunk with no changed rows is not
        even dirtied — a converged super-partition costs zero disk
        write-back."""
        if not mask.any():
            return
        page = self.pool.get((name, s))
        page[mask] = rows
        self.pool.mark_dirty((name, s))

    def pin(self, name: str, s: int):
        self.pool.pin((name, s))

    def unpin(self, name: str, s: int):
        self.pool.unpin((name, s))

    def gather(self, name: str) -> np.ndarray:
        """Reassemble a full relation (the final HDFS-write analogue)."""
        return np.concatenate([self.read(name, s)
                               for s in range(self.n_sp)], axis=0)

    # ---- raw page KV (inbox generations, out/mutation blocks) --------
    def put_page(self, key, arr: np.ndarray, *, immutable: bool = False):
        self.pool.put(key, arr, immutable=immutable)

    def get_page(self, key) -> np.ndarray:
        return self.pool.get(key)

    def delete_page(self, key):
        self.pool.delete(key)

    # ---- background I/O ----------------------------------------------
    def readahead(self, keys):
        """Schedule background faults for ``keys`` (the pages the next
        dispatchable destination will touch) and a clean-ahead pass over
        cold dirty pages. No-op without an engine — the DRAM tier has no
        disk leg to hide."""
        if self.engine is None:
            return 0
        self.engine.clean_ahead()
        return self.engine.prefetch(keys)

    # ---- statistics / checkpoint surface -----------------------------
    def stats(self) -> dict:
        d = self.pool.stats()
        if self.engine is not None:
            d.update(self.engine.stats())
        return d

    def take_interval(self) -> dict:
        """Per-superstep counters (pager + I/O engine) since the last
        call — what the OOC statistics stream records, so the planner
        observes current paging behavior, not cumulative."""
        d = self.pool.take_interval()
        if self.engine is not None:
            d.update(self.engine.take_interval())
        return d

    def occupancy(self) -> dict:
        """Instantaneous tier occupancy for the memory-pressure ledger
        (``obs.memwatch``, a later slice): the pool's DRAM page accounting plus
        the bytes actually occupying the spill directory."""
        d = self.pool.occupancy()
        d["spilling"] = self.spilling
        d["spill_bytes"] = (self.spill.bytes_on_disk()
                            if self.spill is not None else 0)
        return d

    def page_keys(self):
        return self.pool.keys()

    def flush(self):
        if self.engine is not None:
            self.engine.drain()
        self.pool.flush()

    def export_page(self, key, dst_path):
        """Publish one page at ``dst_path`` for a checkpoint. Disk-tier
        pages move at the FILE level (hard-link for immutable pages such
        as inbox generations, kernel copy otherwise) — no DRAM
        re-serialization; DRAM-tier pages serialize through a SpillSlot
        so every exported page carries a CRC trailer either way."""
        page = self.pool.page(key)
        if self.spilling:
            if page.dirty or page.slot is None or not page.slot.exists():
                if page.slot is None:
                    page.slot = self.spill.slot_for(key)
                page.slot.store(self.pool.get(key))
                self.pool.spill_write_bytes += page.nbytes
                page.dirty = False
            page.slot.export_to(dst_path, allow_link=page.immutable)
        else:
            SpillSlot(dst_path).store(self.pool.get(key))

    def adopt_page(self, key, src_path, *, relation: Optional[str] = None,
                   immutable: bool = False):
        """Install a checkpointed page file as page ``key`` (resume
        path). Disk tier: hard-link/copy the file and leave the page
        non-resident (the run faults it in on first touch — resuming
        never streams the whole job through DRAM); DRAM tier: load it."""
        if self.spilling:
            slot = self.spill.slot_for(key)
            slot.adopt(src_path)
            mm = np.load(slot.path, mmap_mode="r")
            nbytes, rows = int(mm.nbytes), mm.shape[0]
            del mm
            self.pool.adopt(key, slot, nbytes, immutable=immutable)
        else:
            arr = SpillSlot(src_path).load()   # verifies the CRC trailer
            rows = arr.shape[0]
            self.pool.put(key, arr)
        if relation is not None:
            self._relations[relation] = rows

    def close(self, *, delete_files: bool = True):
        if self.engine is not None:
            self.engine.close()
        self.pool.close(delete_files=delete_files)
