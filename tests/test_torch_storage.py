"""The port's storage tier (``repro_torch.storage``) on the CPU: the
buffer cache's budget, eviction policies and pins, the background I/O
engine, the spill files both packages read, and the disk tier under
``run_out_of_core`` — bit for bit with the pure-DRAM tier, for every
eviction policy and both executors."""
import threading
import time

import numpy as np
import pytest

import repro.storage as JS
import repro_torch.core as T
import repro_torch.graph as TG
import repro_torch.storage as TS
from repro_torch.core.ooc import run_out_of_core
from repro_torch.storage import (BufferPool, IOEngine, SpillDir, SpillSlot,
                                 TieredStore)

N = 220
EDGES = TG.rmat_graph(N, 1200, seed=7)
ALGOS = {
    "pagerank": (lambda: TG.PageRank(N, iterations=6), 2),
    "sssp": (lambda: TG.SSSP(source=3), 1),
    "cc": (lambda: TG.ConnectedComponents(), 1),
}
# a DRAM budget under the test working set: every spilling run pages
_BUDGET = 16 * 1024
_DRAM = {}


def _vert(vd, P=4):
    return T.load_graph(EDGES, N, P, value_dims=vd, device="cpu")


def _dram(algo):
    if algo not in _DRAM:
        mk, vd = ALGOS[algo]
        res = run_out_of_core(_vert(vd), mk(), mk().suggested_plan,
                              budget_partitions=2, max_supersteps=30,
                              device="cpu")
        _DRAM[algo] = T.gather_values(res.vertex, N)
    return _DRAM[algo]


def _pg(i, kb=4):
    return np.full((kb * 256,), i, np.float32)   # kb KiB a page


# ----------------------------------------------------------------- pager

def test_pool_budget_evicts_and_faults_back(tmp_path):
    pool = BufferPool(2 * _pg(0).nbytes, policy="lru",
                      spill=SpillDir(tmp_path))
    for i in range(3):
        pool.put(i, _pg(i))
    st = pool.stats()
    assert st["evictions"] >= 1
    assert st["peak_resident_bytes"] <= pool.budget
    assert np.array_equal(pool.get(0), _pg(0))
    assert pool.stats()["misses"] >= 1
    assert pool.stats()["spill_read_bytes"] > 0


def test_pool_lru_evicts_cold_mru_evicts_hot(tmp_path):
    for policy, victim in (("lru", 0), ("mru", 1)):
        pool = BufferPool(2 * _pg(0).nbytes, policy=policy,
                          spill=SpillDir(tmp_path / policy))
        pool.put(0, _pg(0))
        pool.put(1, _pg(1))
        pool.get(0), pool.get(1)       # recency: 0 older than 1
        pool.put(2, _pg(2))
        assert not pool.page(victim).resident, policy
        assert pool.page(1 - victim).resident, policy


def test_mru_survives_cyclic_scan_lru_floods(tmp_path):
    """The superstep's access pattern, a cyclic scan over more pages
    than the budget holds: LRU never hits, MRU keeps a prefix."""
    hits = {}
    for policy in ("lru", "mru"):
        pool = BufferPool(2 * _pg(0).nbytes, policy=policy,
                          spill=SpillDir(tmp_path / policy))
        for i in range(4):
            pool.put(i, _pg(i), dirty=True)
        pool.hits = pool.misses = 0
        for _ in range(3):
            for i in range(4):
                pool.get(i)
        hits[policy] = pool.hits
    assert hits["lru"] == 0
    assert hits["mru"] > 0


def test_pool_pinned_pages_never_evicted(tmp_path):
    pool = BufferPool(2 * _pg(0).nbytes, policy="lru",
                      spill=SpillDir(tmp_path))
    pool.put(0, _pg(0))
    pool.put(1, _pg(1))
    pool.pin(0)
    pool.put(2, _pg(2))          # must evict 1, not the pinned 0
    assert pool.page(0).resident
    pool.pin(1)                  # faults 1 back, evicting 2
    with pytest.raises(RuntimeError, match="pinned working set"):
        pool.pin(2)              # both budgeted slots are pinned
    pool.unpin(0)
    pool.unpin(1)
    with pytest.raises(ValueError, match="spill"):
        BufferPool(1024, policy="lru", spill=None)


def test_tiered_store_roundtrip_under_pressure(tmp_path):
    rng = np.random.default_rng(0)
    arrs = {k: rng.random((8, 64)).astype(np.float32) for k in "abc"}
    store = TieredStore(n_sp=4, budget_bytes=3000, disk_dir=tmp_path,
                        policy="mru")
    for k, a in arrs.items():
        store.register(k, a)
    store.write("a", 1, np.ones((2, 64), np.float32))
    arrs["a"][2:4] = 1.0
    mask = np.array([True, False])
    store.write_rows("b", 0, mask, np.full((1, 64), 7, np.float32))
    arrs["b"][0] = 7
    for k in arrs:
        assert np.array_equal(store.gather(k), arrs[k]), k
    assert store.stats()["spill_write_bytes"] > 0
    assert store.stats()["peak_resident_bytes"] <= 3000
    store.close()


def test_take_interval_resets_and_sums_to_cumulative(tmp_path):
    pool = BufferPool(2 * 4096, policy="lru", spill=SpillDir(tmp_path))
    for i in range(3):
        pool.put(i, _pg(i))
    pool.get(0)
    i1 = pool.take_interval()
    assert i1["evictions"] >= 1 and i1["misses"] >= 1
    i2 = pool.take_interval()
    assert i2["misses"] == 0 and i2["spill_read_bytes"] == 0
    pool.get(1)
    i3 = pool.take_interval()
    assert i1["misses"] + i2["misses"] + i3["misses"] == \
        pool.stats()["misses"]


# ------------------------------------------------------------ I/O engine

def _engine_pool(tmp_path, budget_pages=2, threads=1, **kw):
    pool = BufferPool(budget_pages * 4096, policy="lru",
                      spill=SpillDir(tmp_path))
    engine = IOEngine(pool, threads=threads, **kw)
    pool.attach_engine(engine)
    return pool, engine


def test_engine_readahead_turns_fault_into_hit(tmp_path):
    pool, engine = _engine_pool(tmp_path, readahead_pages=8)
    try:
        for i in range(3):
            pool.put(i, _pg(i))
        assert not pool.page(0).resident
        engine.clean_ahead(limit=8)
        engine.prefetch([0])
        engine.drain()
        st0 = pool.stats()
        assert np.array_equal(pool.get(0), _pg(0))
        assert pool.stats()["hits"] == st0["hits"] + 1
        assert pool.stats()["misses"] == st0["misses"]
        assert engine.stats()["io_reads"] >= 1
    finally:
        engine.close()


def test_engine_drains_dirty_pages_on_shutdown(tmp_path):
    pool, engine = _engine_pool(tmp_path, budget_pages=4)
    try:
        for i in range(4):
            pool.put(i, _pg(i))            # all dirty, all resident
        assert engine.clean_ahead(limit=4) > 0
    finally:
        engine.close()
    for i in range(4):
        page = pool.page(i)
        if not page.dirty:
            assert np.array_equal(page.slot.load(), _pg(i))
    assert engine.stats()["io_writes"] >= 1


def test_engine_failed_read_surfaces_cleanly(tmp_path, monkeypatch):
    pool, engine = _engine_pool(tmp_path)
    try:
        for i in range(3):
            pool.put(i, _pg(i))
        pool.flush()
        assert not pool.page(0).resident
        orig = SpillSlot.load

        def boom(self):
            raise OSError("injected read failure")

        monkeypatch.setattr(SpillSlot, "load", boom)
        engine.prefetch([0])
        engine.drain()
        assert isinstance(engine.errors[0], OSError)
        with pytest.raises(OSError, match="injected"):
            pool.get(0)                    # the sync retry surfaces it
        monkeypatch.setattr(SpillSlot, "load", orig)
        assert np.array_equal(pool.get(0), _pg(0))
    finally:
        engine.close()


def test_foreground_get_waits_for_inflight_background_fault(tmp_path,
                                                            monkeypatch):
    pool, engine = _engine_pool(tmp_path)
    gate = threading.Event()
    try:
        for i in range(3):
            pool.put(i, _pg(i))
        pool.flush()
        orig = SpillSlot.load

        def slow(self):
            gate.wait(timeout=10.0)
            return orig(self)

        monkeypatch.setattr(SpillSlot, "load", slow)
        engine.prefetch([0])
        time.sleep(0.05)                   # the engine waits in load
        monkeypatch.setattr(SpillSlot, "load", orig)
        got = {}
        t = threading.Thread(target=lambda: got.update(v=pool.get(0)))
        t.start()
        time.sleep(0.05)
        gate.set()
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert np.array_equal(got["v"], _pg(0))
        # one disk read (the engine's); the foreground get waited on it
        assert pool.stats()["misses"] == 1
    finally:
        gate.set()
        engine.close()


# ------------------------------------------------ pages across packages

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_spill_pages_cross_packages(writer, tmp_path):
    """A page written by either package's SpillSlot is read by the
    other's, bit for bit; a flipped payload byte raises PageCorruption
    in both."""
    mods = {"jax": JS, "torch": TS}
    W, R = mods[writer], mods["torch" if writer == "jax" else "jax"]
    a = np.random.default_rng(1).random((6, 33)).astype(np.float32)
    path = tmp_path / "page.npy"
    W.SpillSlot(path).store(a)
    for mod in (W, R):
        assert np.array_equal(mod.SpillSlot(path).load(), a)
        assert mod.verify_page_file(path)
    raw = bytearray(path.read_bytes())
    raw[-(12 + 5)] ^= 0xFF          # a payload byte before the trailer
    path.write_bytes(bytes(raw))
    for mod in (W, R):
        with pytest.raises(mod.PageCorruption):
            mod.SpillSlot(path).load()
        assert not mod.verify_page_file(path)


# ------------------------------------------------- disk tier, end to end

@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("policy", ["lru", "mru"])
@pytest.mark.parametrize("streaming", [False, True])
def test_disk_tier_parity_bit_for_bit(algo, policy, streaming, tmp_path):
    """The disk tier only moves bytes: a run that spills under a budget
    equals the pure-DRAM run exactly."""
    mk, vd = ALGOS[algo]
    res = run_out_of_core(_vert(vd), mk(), mk().suggested_plan,
                          budget_partitions=2, max_supersteps=30,
                          stream=streaming, memory_budget_bytes=_BUDGET,
                          disk_dir=tmp_path, eviction=policy,
                          io_threads=1 if streaming else 0,
                          device="cpu")
    assert np.array_equal(T.gather_values(res.vertex, N), _dram(algo))
    recs = [s for s in res.stats if "wall_s" in s]
    assert recs and all(s["spill"] for s in recs)
    assert sum(s["spill_write_bytes"] for s in recs) > 0
    assert all(0.0 <= s["cache_hit_rate"] <= 1.0 for s in recs)
    assert all(s["pager_peak_bytes"] <= _BUDGET for s in recs)


def test_pager_counters_reset_per_superstep(tmp_path):
    """Each record carries its own superstep's paging, not a running
    total."""
    prog = TG.PageRank(N, iterations=6)
    res = run_out_of_core(_vert(2), prog, prog.suggested_plan,
                          budget_partitions=2, max_supersteps=10,
                          memory_budget_bytes=_BUDGET, disk_dir=tmp_path,
                          io_threads=0, device="cpu")
    recs = [s for s in res.stats if "spill_read_bytes" in s]
    assert len(recs) >= 3
    steady = [s["spill_read_bytes"] for s in recs[1:]]
    assert max(steady) < sum(steady)
    assert "metrics" in recs[-1] and "ooc.prepare_s" in recs[-1]["metrics"]
