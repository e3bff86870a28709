"""Tier-occupancy ledger: HBM / DRAM / SSD accounting per superstep —
the port's copy of ``repro.obs.memwatch``.

Wall time is a late signal of memory pressure — a tier fills long before
the run slows (the out-of-core literature's consistent finding). This
module samples all three storage tiers at superstep boundaries:

* **HBM** — on a CUDA device, what the caching allocator holds
  (``torch.cuda.memory_allocated``) and its peak
  (``max_memory_allocated``), read through the callable the driver
  binds (this module imports no torch): the shape estimate below reads
  3.6-4.5x under it on an H100, since it leaves out every temporary of
  the superstep. On the CPU (and on meta tensors) the estimate: the
  device working set is static per plan: relation
  capacities from ``EngineConfig`` (``bucket_cap`` / ``frontier_cap`` /
  ``mutation_cap``) times the vertex/edge/message shapes, times the
  partitions resident at once (the OOC stream keeps
  ``budget_partitions``; in-memory drivers keep all of them).
* **DRAM** — live page accounting from the ``BufferPool``
  (:meth:`repro_torch.storage.pager.BufferPool.occupancy`): resident / dirty /
  pinned bytes under the pool lock, plus the hard ``memory_budget_bytes``
  cap and the peak watermark. Sharded runs sum their per-worker stores.
* **SSD** — bytes actually on disk in the spill directory
  (:meth:`repro_torch.storage.spillfile.SpillDir.bytes_on_disk`) plus the
  cumulative fault/write-back counters.

Each sample carries an OOM-proximity gauge for the budgeted DRAM tier:
``occupancy`` (resident / budget) and ``headroom_bytes`` — occupancy is
the early-warning signal, not wall time. Peaks/watermarks accumulate in
:attr:`MemWatch.peaks` across the run.

Mirrors the tracer's module switch (``start/stop/get/enabled``); all
record calls are no-ops returning ``None`` while disabled.
"""
from __future__ import annotations

from typing import Optional

# wire widths (mirror core shapes: int32 ids, float32 payloads, bool
# validity/halt masks)
_W = 4


def _msg_slot_bytes(msg_dims: int) -> int:
    # dst int32 + payload (D,) float32 + valid bool
    return (1 + msg_dims) * _W + 1


class MemWatch:
    """Per-run occupancy samples + peak watermarks for the three tiers."""

    def __init__(self):
        self.samples: list = []
        self.peaks: dict = {}
        self._hbm_ctx: Optional[dict] = None
        self._budget: Optional[int] = None
        self._allocator = None      # () -> (bytes in use, peak bytes)

    # ---- run context -------------------------------------------------
    def configure(self, *, ec=None, Np: int = 0, Ep: int = 0,
                  value_dims: int = 1, msg_dims: int = 1,
                  budget_bytes: Optional[int] = None,
                  n_workers: int = 1, allocator=None):
        """Bind the shapes the HBM estimate needs (``ec`` is the
        resolved ``EngineConfig``) and the DRAM budget for the OOM
        gauge. Without it, samples carry only what the stores report.
        ``allocator`` (a CUDA device's: ``driver.cuda_allocator``)
        returns the device allocator's (bytes in use, peak bytes), which
        the HBM sample then reads in place of the estimate."""
        if allocator is not None:
            self._allocator = allocator
        if ec is not None:
            self._hbm_ctx = {
                "n_parts": int(ec.n_parts),
                "bucket_cap": int(ec.bucket_cap),
                "frontier_cap": int(ec.frontier_cap),
                "mutation_cap": int(ec.mutation_cap),
                "Np": int(Np), "Ep": int(Ep),
                "value_dims": int(value_dims),
                "msg_dims": int(msg_dims),
                "n_workers": max(int(n_workers), 1),
            }
        if budget_bytes is not None:
            self._budget = int(budget_bytes)
        return self

    def hbm_estimate(self, resident_parts: Optional[int] = None) -> \
            Optional[dict]:
        """Device-tier working set in bytes for ``resident_parts``
        partitions resident at once (None = all of them)."""
        c = self._hbm_ctx
        if c is None:
            return None
        P = c["n_parts"] if resident_parts is None \
            else max(int(resident_parts), 1)
        Np, Ep = c["Np"], c["Ep"]
        D, V = c["msg_dims"], c["value_dims"]
        vertex = P * Np * (2 * _W + 1 + V * _W)   # vid, halt, value
        edge = P * Ep * 3 * _W                    # src, dst, val
        msg = P * c["n_parts"] * c["bucket_cap"] * _msg_slot_bytes(D)
        frontier = P * c["frontier_cap"] * _W
        mutation = (P * c["n_parts"] * c["mutation_cap"]
                    * _msg_slot_bytes(V))
        total = (vertex + edge + msg + frontier
                 + mutation) * c["n_workers"]
        return {"total_bytes": total, "vertex_bytes": vertex,
                "edge_bytes": edge, "message_bytes": msg,
                "frontier_bytes": frontier, "mutation_bytes": mutation,
                "resident_parts": P}

    def hbm_allocated(self) -> Optional[dict]:
        """The device allocator's bytes in use now and at their peak, or
        None when no allocator was configured."""
        if self._allocator is None:
            return None
        used, peak = self._allocator()
        return {"total_bytes": int(used), "peak_bytes": int(peak),
                "source": "allocator"}

    # ---- per-superstep sample ----------------------------------------
    def sample(self, superstep: int, *, store=None, stores=None,
               resident_parts: Optional[int] = None) -> dict:
        """Snapshot all tiers at a superstep boundary. ``store`` is the
        driver's ``TieredStore`` (or ``stores`` the sharded per-worker
        list); in-memory runs pass neither and get an HBM-only sample."""
        s = {"superstep": int(superstep)}
        hbm = self.hbm_allocated()
        if hbm is not None:
            s["hbm"] = hbm
            self._peak("hbm_bytes", hbm["peak_bytes"])
        else:
            hbm = self.hbm_estimate(resident_parts)
            if hbm is not None:
                s["hbm"] = hbm
                self._peak("hbm_bytes", hbm["total_bytes"])
        occs = []
        if store is not None:
            occs.append(store.occupancy())
        for st in (stores or ()):
            occs.append(st.occupancy())
        if occs:
            dram = {"resident_bytes": 0, "dirty_bytes": 0,
                    "pinned_bytes": 0, "peak_resident_bytes": 0,
                    "budget_bytes": None}
            ssd = {"spill_bytes": 0, "spill_read_bytes": 0,
                   "spill_write_bytes": 0}
            for o in occs:
                for k in ("resident_bytes", "dirty_bytes",
                          "pinned_bytes", "peak_resident_bytes"):
                    dram[k] += int(o.get(k, 0))
                if o.get("budget_bytes") is not None:
                    dram["budget_bytes"] = ((dram["budget_bytes"] or 0)
                                            + int(o["budget_bytes"]))
                for k in ssd:
                    ssd[k] += int(o.get(k, 0))
            budget = dram["budget_bytes"]
            if budget is None:
                budget = self._budget
                dram["budget_bytes"] = budget
            if budget:
                # OOM proximity: how full the budgeted tier is, and how
                # many bytes of slack remain before the pager must evict
                dram["occupancy"] = dram["resident_bytes"] / budget
                dram["headroom_bytes"] = budget - dram["resident_bytes"]
            s["dram"] = dram
            s["ssd"] = ssd
            self._peak("dram_resident_bytes", dram["resident_bytes"])
            self._peak("dram_dirty_bytes", dram["dirty_bytes"])
            self._peak("dram_pinned_bytes", dram["pinned_bytes"])
            self._peak("dram_peak_resident_bytes",
                       dram["peak_resident_bytes"])
            if budget:
                self._peak("dram_occupancy", dram["occupancy"])
            self._peak("ssd_spill_bytes", ssd["spill_bytes"])
        self.samples.append(s)
        return s

    def _peak(self, key: str, value):
        if value > self.peaks.get(key, 0):
            self.peaks[key] = value

    def as_dict(self) -> dict:
        d = {"samples": list(self.samples), "peaks": dict(self.peaks)}
        if self._budget is not None:
            d["memory_budget_bytes"] = self._budget
        return d


# ---- module-level switch (mirrors obs.trace) -------------------

_WATCH: Optional[MemWatch] = None


def start() -> MemWatch:
    global _WATCH
    _WATCH = MemWatch()
    return _WATCH


def stop() -> Optional[MemWatch]:
    global _WATCH
    w, _WATCH = _WATCH, None
    return w


def get() -> Optional[MemWatch]:
    return _WATCH


def enabled() -> bool:
    return _WATCH is not None


def configure(**kw):
    """Fire-and-forget context bind — None when memwatch is off."""
    w = _WATCH
    return w.configure(**kw) if w is not None else None


def sample(superstep, **kw):
    """Fire-and-forget tier snapshot — None when memwatch is off."""
    w = _WATCH
    return w.sample(superstep, **kw) if w is not None else None
