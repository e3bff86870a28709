"""The port's ``run_out_of_core`` against the JAX package's on the CPU.

PageRank, SSSP and CC stream through the partial superstep one
super-partition at a time, across both connectors and both storage
policies: integer and bool fields, SSSP/CC values and superstep counts
must equal the reference's; PageRank's ranks within rtol 1e-5, atol 1e-7
(the port's standing contract: its float sums add in torch's order). The
port also equals its own ``run_host`` bit for bit, as the reference
does. One reference run per algorithm (its suggested plan) serves the
whole connector x storage matrix: a storage policy changes no value
(the reference holds both to its run_host bit for bit, tests/test_ooc.py),
and a connector changes only the order of PageRank's float sums, which
the rtol covers — each JAX run costs seconds of compiles.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as J
import repro.graph as JG
import repro_torch.core as T
import repro_torch.graph as TG
from repro.core.ooc import run_out_of_core as j_ooc
from repro_torch.core.ooc import (_host_slot_of, _pad_run_width,
                                  _round_run_width, _sort_inbox_runs,
                                  run_out_of_core)

N = 220
EDGES = TG.rmat_graph(N, 1200, seed=7)
ALGOS = {
    "pagerank": (lambda: JG.PageRank(N, iterations=6),
                 lambda: TG.PageRank(N, iterations=6), 2),
    "sssp": (lambda: JG.SSSP(source=3), lambda: TG.SSSP(source=3), 1),
    "cc": (lambda: JG.ConnectedComponents(),
           lambda: TG.ConnectedComponents(), 1),
}
_REF = {}


def _tplan(prog, **kw):
    return dataclasses.replace(prog.suggested_plan, **kw)


def _tvert(vd, P=4):
    return T.load_graph(EDGES, N, P, value_dims=vd, device="cpu")


def _ref(algo):
    """The JAX package's out-of-core run (suggested plan,
    budget_partitions=2) -> its values, vid, halt, superstep count,
    per-superstep active and message counts, and overflow vector."""
    if algo not in _REF:
        mk_j, _, vd = ALGOS[algo]
        res = j_ooc(J.load_graph(EDGES, N, P=4, value_dims=vd), mk_j(),
                    mk_j().suggested_plan, budget_partitions=2,
                    max_supersteps=30)
        _REF[algo] = dict(
            values=J.gather_values(res.vertex, N),
            vid=np.asarray(res.vertex.vid), halt=np.asarray(res.vertex.halt),
            supersteps=res.supersteps,
            active=[s["active"] for s in res.stats if "wall_s" in s],
            messages=[s["messages"] for s in res.stats if "wall_s" in s],
            overflow=np.asarray(res.gs.overflow))
    return _REF[algo]


def _check(algo, ref, res):
    got = T.gather_values(res.vertex, N)
    if algo == "pagerank":
        np.testing.assert_allclose(got, ref["values"], rtol=1e-5, atol=1e-7)
    else:
        assert np.array_equal(got, ref["values"])
    assert np.array_equal(res.vertex.vid.numpy(), ref["vid"])
    assert np.array_equal(res.vertex.halt.numpy(), ref["halt"])
    assert res.supersteps == ref["supersteps"]
    recs = [s for s in res.stats if "wall_s" in s]
    assert [s["active"] for s in recs] == ref["active"]
    assert [s["messages"] for s in recs] == ref["messages"]
    assert np.array_equal(res.gs.overflow.numpy(), ref["overflow"])


@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("connector",
                         ["partitioning", "partitioning_merging"])
@pytest.mark.parametrize("storage", ["inplace", "delta"])
def test_ooc_matches_reference(algo, connector, storage):
    _, mk_t, vd = ALGOS[algo]
    res = run_out_of_core(_tvert(vd), mk_t(),
                          _tplan(mk_t(), connector=connector,
                                 storage=storage),
                          budget_partitions=2, max_supersteps=30,
                          device="cpu")
    _check(algo, _ref(algo), res)
    assert isinstance(res.vertex.value, torch.Tensor)
    assert res.vertex.value.device.type == "cpu"
    recs = [s for s in res.stats if "wall_s" in s]
    assert all(s["ooc"] and s["storage"] == storage for s in recs)
    assert all(0.0 <= s["change_density"] <= 1.0 for s in recs)


@pytest.mark.parametrize("algo", list(ALGOS))
def test_ooc_equals_run_host_bit_for_bit(algo):
    """One set of plans in memory and out of core: the run-structured
    inbox hands the receiver the in-memory exchange's layout, so even the
    float sums add in the same order."""
    _, mk_t, vd = ALGOS[algo]
    host = T.run_host(_tvert(vd), mk_t(), mk_t().suggested_plan,
                      max_supersteps=30)
    for sp in (1, 2):
        res = run_out_of_core(_tvert(vd), mk_t(), mk_t().suggested_plan,
                              budget_partitions=sp, max_supersteps=30,
                              device="cpu")
        assert np.array_equal(T.gather_values(res.vertex, N),
                              T.gather_values(host.vertex, N)), sp
        assert res.supersteps == host.supersteps


def test_bucket_overflow_regrows_instead_of_raising():
    """bucket_cap=2 overflows superstep 0's sends: regrow and redo, with
    the reference's final capacity and values."""
    mk_j, mk_t, _ = ALGOS["sssp"]
    jres = j_ooc(J.load_graph(EDGES, N, P=4, value_dims=1), mk_j(),
                 mk_j().suggested_plan, budget_partitions=2,
                 max_supersteps=30,
                 ec=J.EngineConfig(n_parts=4, bucket_cap=2,
                                   frontier_cap=_tvert(1).capacity + 8))
    vert = _tvert(1)
    ec = T.EngineConfig(n_parts=4, bucket_cap=2,
                        frontier_cap=vert.capacity + 8)
    res = run_out_of_core(vert, mk_t(), mk_t().suggested_plan,
                          budget_partitions=2, max_supersteps=30, ec=ec,
                          device="cpu")
    regrows = [s for s in res.stats if s.get("event") == "regrow"]
    jregrows = [s for s in jres.stats if s.get("event") == "regrow"]
    assert regrows and regrows[-1]["bucket_cap"] > 2
    assert [(r["superstep"], r["bucket_cap"], r["sources"], r["redo"])
            for r in regrows] == \
        [(r["superstep"], r["bucket_cap"], r["sources"], r["redo"])
         for r in jregrows]
    assert np.array_equal(T.gather_values(res.vertex, N),
                          J.gather_values(jres.vertex, N))


@pytest.mark.parametrize("streaming", [False, True])
def test_streaming_overflow_mid_pipeline_regrows(streaming):
    """Bucket AND frontier overflow while later super-partitions are in
    flight: the pipeline unwinds, regrows, redoes, and lands on the same
    state as the synchronous run and run_host."""
    _, mk_t, _ = ALGOS["sssp"]
    ec = T.EngineConfig(n_parts=4, bucket_cap=2, frontier_cap=0)
    res = run_out_of_core(_tvert(1), mk_t(), mk_t().suggested_plan,
                          budget_partitions=1, max_supersteps=30, ec=ec,
                          stream=streaming, prefetch_depth=4,
                          device="cpu")
    regrows = [s for s in res.stats if s.get("event") == "regrow"]
    assert regrows and regrows[-1]["bucket_cap"] > 2
    host = T.run_host(_tvert(1), mk_t(), mk_t().suggested_plan,
                      max_supersteps=30)
    assert np.array_equal(T.gather_values(res.vertex, N),
                          T.gather_values(host.vertex, N))


def test_overflow_attributed_to_source_leaves_buckets_alone():
    """A frontier overflow regrows the frontier only (the reference's
    attribution, tests/test_ooc.py), and lands on run_host's state."""
    _, mk_t, _ = ALGOS["sssp"]
    res = run_out_of_core(_tvert(1), mk_t(),
                          _tplan(mk_t(), join="left_outer"),
                          budget_partitions=2, max_supersteps=30,
                          ec=T.EngineConfig(n_parts=4, bucket_cap=64,
                                            frontier_cap=4),
                          device="cpu")
    regrows = [s for s in res.stats if s.get("event") == "regrow"]
    assert regrows and regrows[-1]["frontier_cap"] > 4
    assert all(r["bucket_cap"] == 64 for r in regrows)
    assert all(r["sources"] == [T.OVF_FRONTIER] for r in regrows)
    host = T.run_host(_tvert(1), mk_t(), _tplan(mk_t(), join="left_outer"),
                      max_supersteps=30)
    assert np.array_equal(T.gather_values(res.vertex, N),
                          T.gather_values(host.vertex, N))


# ------------------------------------------------------------- helpers

def test_host_helpers_match_reference():
    """The host-side helpers are the reference's, array for array."""
    import repro.core.ooc as jo
    rng = np.random.default_rng(3)
    P, C, D = 3, 8, 2
    dst = rng.integers(0, 50, (P, P, C)).astype(np.int32)
    val = np.sort(rng.random((P, P, C)) > 0.4, axis=2)[:, :, ::-1]
    dst = np.where(val, dst, -1)
    pay = rng.random((P, P, C, D)).astype(np.float32)
    for a, b in zip(_sort_inbox_runs((dst, pay, val)),
                    jo._sort_inbox_runs((dst, pay, val))):
        assert np.array_equal(a, b)
    for a, b in zip(_pad_run_width((dst, pay, val), 12),
                    jo._pad_run_width((dst, pay, val), 12)):
        assert np.array_equal(a, b)
    assert _pad_run_width((dst, pay, val), 8)[0] is dst
    for part in ("hash", "range"):
        assert np.array_equal(_host_slot_of(dst, val, 17, P, part),
                              jo._host_slot_of(dst, val, 17, P, part))
    for m, cap in ((0, 64), (1, 64), (3, 64), (33, 64), (200, 64)):
        assert _round_run_width(m, cap) == jo._round_run_width(m, cap)


def test_device_and_kernel_impl_must_agree():
    """device='cuda' without a card raises, and so does a kernel knob
    that disagrees with the device: nothing falls back."""
    _, mk_t, _ = ALGOS["sssp"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_out_of_core(_tvert(1), mk_t(), mk_t().suggested_plan,
                            budget_partitions=2)
    with pytest.raises(ValueError, match="kernel_impl"):
        run_out_of_core(_tvert(1), mk_t(), mk_t().suggested_plan,
                        budget_partitions=2, kernel_impl="cuda",
                        device="cpu")
    with pytest.raises(ValueError, match="kernel_impl"):
        run_out_of_core(_tvert(1), mk_t(),
                        _tplan(mk_t(), kernel_impl="cuda"),
                        budget_partitions=2, device="cpu")
