"""CPU tests of the genome cell's parts at a few thousand bases: the de
Bruijn generator's counts, the port's PathMerge on its own plan against
the plain reference (values and the mutation counters a superstep), a
whole run of the harness, and the planted faults that must come out not
correct."""
import pytest
import torch

import repro_torch.graph as TG
from bench import graphs, harness, manifest as mf
from bench.algorithms import pathmerge
from bench.generators import debruijn
from bench.test_bench_parts import cell_of
from bench.test_bench_runs import FAULTS
from repro_torch.core import gather_values, load_graph, run_host
from repro_torch.core.driver import MUTATION_COUNTERS

CELL = "gage-chr14-k31.pathmerge"
SEED = 2 ** 31 + 29
K = 31
# the configuration's repeat model with a library cut to fit a few
# thousand bases: its families' shares and divergences, shorter copies
SMALL_LIBRARY = {"repeat_consensus": {"Alu": 120, "L1": 400},
                 "repeat_families": [
                     {**f, "copy_length": (f["copy_length"] if
                                           f["copy_length"] == "full"
                                           else 150)}
                     for f in mf.config("gage-chr14-k31")["repeat_families"]]}
GENOMES = {
    "repeats": {"bases": 6000, **SMALL_LIBRARY},
    "bare_chain": {"bases": 2000, "repeat_families": []},
    # exact copies: every copy's ends are branch points
    "branch_points": {"bases": 3000, "repeat_consensus": {"R": 80},
                      "repeat_families": [
                          {"family": "R", "consensus": "R", "share": 0.4,
                           "copy_length": "full", "divergence": 0.0}]},
}


def genome(name, seed=SEED) -> graphs.Graph:
    """The genome's graph, its edges int64 as the harness hands them to
    the reference (``graphs.to_int64``)."""
    g = graphs.make_graph({**mf.config("gage-chr14-k31"),
                           **GENOMES[name]}, seed, "cpu")
    g.edges = graphs.to_int64(g.edges, "cpu")
    return g


def test_a_sequence_without_repeats_is_two_chains():
    """Each strand of B bases has B - 30 distinct 31-mers, each followed by
    the next: two chains, one a strand."""
    B = GENOMES["bare_chain"]["bases"]
    g = genome("bare_chain")
    assert g.n == 2 * (B - K + 1) and g.num_edges == 2 * (B - K)
    assert g.listed_edges == g.num_edges
    src, dst = g.edges[:, 0], g.edges[:, 1]
    out = torch.bincount(src, minlength=g.n)
    inn = torch.bincount(dst, minlength=g.n)
    assert int(out.max()) == 1 and int(inn.max()) == 1
    nxt = torch.full((g.n,), -1, dtype=torch.int64)
    nxt[src] = dst
    lengths = []
    for head in torch.nonzero(inn == 0).squeeze(1).tolist():
        length, v = 1, head
        while int(nxt[v]) >= 0:
            v, length = int(nxt[v]), length + 1
        lengths.append(length)
    assert lengths == [B - K + 1] * 2


def test_kmer_codes_and_strands():
    seq = torch.tensor([0, 1, 2, 3, 3], dtype=torch.uint8)     # ACGTT
    assert debruijn.kmer_codes(seq, 3).tolist() == \
        [0b000110, 0b011011, 0b101111]
    assert debruijn.reverse_complement(seq).tolist() == [0, 0, 1, 2, 3]


def test_repeats_make_branch_points_and_share_kmers():
    """Copies of a repeat share k-mers, so fewer vertices than 31-mer
    positions, and where copies part the graph branches; a de Bruijn
    vertex has at most 4 successors. The same dataset seed gives the same
    graph, and the run's seed only relabels it inside the partitions."""
    for name in ("repeats", "branch_points"):
        B = GENOMES[name]["bases"]
        g = genome(name)
        out = torch.bincount(g.edges[:, 0], minlength=g.n)
        assert g.n < 2 * (B - K + 1)
        assert int(out.max()) <= 4 and int((out >= 2).sum()) > 0
        e = g.edges
        key = e[:, 0] * g.n + e[:, 1]
        assert bool((key[1:] > key[:-1]).all())
    a, b = genome("repeats", 1), genome("repeats", 2)
    assert (a.n, a.num_edges) == (b.n, b.num_edges)
    assert not torch.equal(a.edges, b.edges)
    deg = lambda g: torch.sort(torch.bincount(g.edges[:, 0], minlength=g.n)
                               ).values
    assert torch.equal(deg(a), deg(b))


def test_config_states_the_repeat_model():
    cfg = mf.config("gage-chr14-k31")
    share = {}
    for f in cfg["repeat_families"]:
        share[f["consensus"]] = share.get(f["consensus"], 0) + f["share"]
    assert share == pytest.approx({"Alu": 0.106, "L1": 0.169}, abs=1e-4)
    assert cfg["k"] == K and cfg["bases"] < cfg["published_bases"]
    assert cfg["bases"] % 1_000_000 == 0


@pytest.mark.parametrize("name", sorted(GENOMES))
def test_port_equals_the_reference(name):
    """The port's PathMerge on its own plan (the sort group-by, delta
    storage, full-outer) against the plain replay: every (acc, degree),
    the mass, and the deletions and resurrections of each superstep, as
    ``run_host`` publishes them."""
    g = genome(name)
    prog = TG.PathMerge()
    vert = load_graph(g.edges.numpy(), g.n, 4, value_dims=2, device="cpu")
    res = run_host(vert, prog, prog.suggested_plan, max_supersteps=100)
    assert res.supersteps == prog.rounds + 1
    want = pathmerge.reference(g.edges, g.n, {"rounds": prog.rounds})
    got = gather_values(res.vertex, g.n)
    assert pathmerge.compare(got, want) == {"wrong_vertices": 0}
    ref = pathmerge.replay(g.edges, g.n, prog.rounds)
    recs = [s["metrics"] for s in res.stats if "wall_s" in s]
    assert [[int(m[c]) for c in MUTATION_COUNTERS] for m in recs] == \
        [list(x) for x in zip(ref.deleted, ref.resurrected)]
    assert sum(ref.deleted) > 0 and sum(ref.resurrected) > 0


def test_control_loses_what_resurrection_keeps():
    g = genome("repeats")
    args = {"rounds": 8}
    got = pathmerge.control(g.edges, g.n, args)
    assert pathmerge.compare(got, pathmerge.reference(g.edges, g.n, args)
                             )["wrong_vertices"] > 0
    assert got[:, 0].sum() < g.n


def run(seed=SEED):
    return harness.run_cell(CELL, seed, 0.01, False, device="cpu",
                            overrides=GENOMES["repeats"], cell=cell_of(CELL),
                            log=lambda *a: None)


def test_sound_run_is_correct():
    out = run()
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"] == {"wrong_vertices": {"value": 0, "limit": 0}}
    assert {"evps", "setup_s"} <= set(out["metrics"])


def _no_resurrection(monkeypatch):
    # a message to a deleted slot is then dropped: nothing re-creates it
    monkeypatch.setattr(TG.PathMerge, "mutates", False)


def _both_parities(monkeypatch):
    real = TG.PathMerge.compute

    def compute(self, vid, value, msg, has_msg, active, gs):
        # every live vid passes the parity test of this superstep
        par = (gs.superstep % 2).to(vid.dtype).expand(vid.shape)
        return real(self, torch.where(vid >= 0, par, vid), value, msg,
                    has_msg, active, gs)
    monkeypatch.setattr(TG.PathMerge, "compute", compute)


PM_FAULTS = {"no_resurrection": _no_resurrection,
             "both_parities": _both_parities,
             "half_the_messages": FAULTS["half_the_messages"],
             "answer_altered": FAULTS["answer_altered"]}


@pytest.mark.parametrize("fault", sorted(PM_FAULTS))
def test_broken_path_is_not_correct(fault, monkeypatch):
    PM_FAULTS[fault](monkeypatch)
    out = run()
    assert out["correct"] is False
    assert out["checks"]["wrong_vertices"]["value"] > 0
