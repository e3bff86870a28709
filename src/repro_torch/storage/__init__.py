"""Buffer-cache storage subsystem of the port: the HBM ↔ host DRAM ↔
disk tier (the port's copy of ``repro.storage``).

The paper's out-of-core execution spills every operator through the
Hyracks buffer cache (Sections 2.3/5.4); this package is that layer:

* ``pager``     — page-granular buffer cache: DRAM byte budget, LRU and
                  cyclic-scan-resistant (MRU) eviction, pin/unpin for
                  in-flight pipeline slots, lazy dirty-page write-back
* ``spillfile`` — mmap-backed ``.npy`` page files with atomic,
                  CRC-trailed writes (the reference's bytes on disk)
* ``io_engine`` — background page-I/O worker threads: readahead of the
                  next dispatchable destination's pages, coalesced
                  dirty-page drain in eviction order (disk and numpy
                  work only; no CUDA call runs on them)
* ``tiered``    — ``TieredStore``, the facade ``core/ooc.py``'s
                  dispatcher/collector runs on

Entry point: ``repro_torch.core.ooc.run_out_of_core(...,
memory_budget_bytes=..., disk_dir=..., eviction=..., io_threads=...,
readahead_pages=...)``.
"""
from repro_torch.storage.io_engine import (DEFAULT_RETRY, IOEngine,
                                           RetryPolicy, retry_io)
from repro_torch.storage.pager import EVICTION_POLICIES, BufferPool, Page
from repro_torch.storage.spillfile import (PageCorruption, SpillDir,
                                           SpillSlot, page_checksum,
                                           verify_page_file)
from repro_torch.storage.tiered import TieredStore

__all__ = ["EVICTION_POLICIES", "BufferPool", "IOEngine", "Page",
           "PageCorruption", "RetryPolicy", "DEFAULT_RETRY", "retry_io",
           "SpillDir", "SpillSlot", "TieredStore", "page_checksum",
           "verify_page_file"]
