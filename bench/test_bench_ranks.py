"""CPU tests of the harness on several chips, and of the graph steps that
make a graph500-26-sized graph within one card: a cell whose ``chips`` is
4 runs through the port's ``run_sharded`` over four gloo ranks, is
correct, and keeps the one-chip run's answers bit for bit; a fault in the
sharded answers comes out not correct; nothing runs on one card's path;
every process's memory is counted; a rank that loads a banned module
makes the command refuse; the ranks' trace readings are on one scale; and
the blocked graph steps give the edge lists of the plain whole-list steps
kept below."""
import copy
import importlib
import json
import os
import sys

# one intra-op thread a test process, as tests/_torch_threads.py sets it:
# pytest-xdist's workers and the rank pools share the host's cores
os.environ.setdefault("OMP_NUM_THREADS", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro_torch.core as core  # noqa: E402
import repro_torch.core.sharded as sharded  # noqa: E402
from bench import (graphs, harness, manifest as mf,  # noqa: E402
                   run as bench_run, stages)
from bench.algorithms import pagerank  # noqa: E402
from bench.test_bench_parts import cell_of  # noqa: E402

torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))

WORKLOAD = "graph500-22.pagerank"
SMALL = {"scale": 10}
SEED = 2 ** 31 + 23


def run(chips, monkeypatch, trace=False):
    """A CPU run of graph500-22's PageRank at scale 10 on ``chips``
    ranks; -> (result line, the answers the run judged)."""
    kept = []
    real = core.gather_values

    def gather(vert, n):
        out = real(vert, n)
        kept.append(out)
        return out
    monkeypatch.setattr(core, "gather_values", gather)
    out = harness.run_cell(WORKLOAD, SEED, 0.0, trace, device="cpu",
                           overrides=SMALL,
                           cell=dict(cell_of(WORKLOAD), chips=chips),
                           log=lambda *a: None)
    return out, kept


def _import(name, *, axis=None):
    """Load ``name`` in a rank (``RankPool.map``)."""
    importlib.import_module(name)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One untraced run on four ranks, each of which loads a stub
    ``flax`` (first on the ranks' path) after it starts; -> ``run``'s
    pair."""
    stub = tmp_path_factory.mktemp("stub")
    (stub / "flax").mkdir()
    (stub / "flax" / "__init__.py").write_text("")

    class Loading(sharded.RankPool):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.map(_import, [("flax",)] * self.n_workers)
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(stub))        # spawned ranks inherit it
        mp.setattr(sharded, "RankPool", Loading)
        return run(4, mp)


def test_sharded_run_keeps_the_one_chip_answers(four_ranks, monkeypatch):
    one, want = run(1, monkeypatch)
    four, got = four_ranks
    assert one["correct"] is True and four["correct"] is True
    assert four["failed"] == 0 and four["device"]["count"] == 4
    assert got and all(np.array_equal(g, want[0]) for g in got)
    assert set(four["metrics"]) == set(one["metrics"])
    json.dumps(four)


def _altered(vertex):
    """+1 on the first live vertex's first value column."""
    val = vertex.value.clone()
    val[tuple(torch.nonzero(vertex.vid >= 0)[0])] += 1.0
    vertex.value = val


def _unchanged(vertex):
    """The values the job started from: nothing computed."""
    vertex.value = torch.zeros_like(vertex.value)


@pytest.mark.parametrize("fault", [_altered, _unchanged],
                         ids=["answer_altered", "state_unchanged"])
def test_fault_in_the_sharded_answers_is_not_correct(fault, monkeypatch):
    real = sharded._assemble

    def assemble(vert, replies, t0):
        res = real(vert, replies, t0)
        fault(res.vertex)
        return res
    monkeypatch.setattr(sharded, "_assemble", assemble)
    out, _ = run(4, monkeypatch)
    assert out["correct"] is False
    assert out["checks"]["max_rel_err"]["value"] > \
        out["checks"]["max_rel_err"]["limit"]


def test_several_chips_run_nothing_of_one_card(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("one card's path ran")
    monkeypatch.setattr(core, "run_host", refuse)
    monkeypatch.setattr(stages, "replay", refuse)
    out, _ = run(4, monkeypatch, trace=True)
    assert out["correct"] is True and out["attempted"] >= harness.TRACE_JOBS
    # the ranks' own profiles: on the CPU a window, and no device time
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
    assert "breakdown" in out
    by_stage = {m["name"] for m in mf.metrics_of(mf.load(), WORKLOAD, True)
                if getattr(mf.metric_reader(m["name"]), "stages",
                           None) is stages}
    assert by_stage and not by_stage & set(out["metrics"])


def test_a_banned_module_in_a_rank_refuses_the_command(
        four_ranks, monkeypatch, capsys):
    """The ranks' stub ``flax`` comes out of the harness, and the command
    prints no result and names it."""
    out, _ = four_ranks
    assert out["banned_in_ranks"] == ["flax"]
    assert "flax" not in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a, **k: copy.deepcopy(out))
    capsys.readouterr()
    rc = bench_run.main(["--workload", WORKLOAD, "--seed", str(SEED),
                         "--seconds", "0", "--trace", "0"])
    got = capsys.readouterr()
    assert rc != 0 and got.out == ""
    assert "['flax'] in the ranks" in got.err


def test_ranks_trace_readings_are_a_ranks_means():
    """Every field of the merged reading is a rank's mean, and a kernel's
    seconds are summed back over the ranks for its roofline."""
    from bench import ranktrace, timeline
    a = timeline.TraceReading(window_s=4.0, busy_s=3.0,
                              kernel_s={"fold_tiles": 2.0, "x": 1.0},
                              gaps=[("gloo:all_to_all", 0.6)])
    b = timeline.TraceReading(window_s=2.0, busy_s=1.0,
                              kernel_s={"fold_tiles": 1.0},
                              gaps=[("gloo:all_to_all", 0.2),
                                    ("host (no op)", 0.4)])
    m = ranktrace.merge([a, b])
    assert (m.window_s, m.busy_s, m.ranks) == (3.0, 2.0, 2)
    assert m.top_ops() == [["fold_tiles", 1.5], ["x", 0.5]]
    assert m.top_gaps() == [["gloo:all_to_all", 0.4], ["host (no op)", 0.2]]
    assert sum(s for _, s in m.top_ops()) <= m.busy_s
    assert m.kernel_seconds("fold_tiles") == 3.0
    assert timeline.TraceReading(1.0, 1.0, {"fold_tiles": 2.0}) \
        .kernel_seconds("fold_tiles") == 2.0


def test_memory_counts_every_process():
    """The window's bytes are this process's plus each rank's largest
    over the jobs; the fullest card sums the processes on it."""
    p = harness.RankPeaks()
    p.add([{"rank": 0, "device": "cuda:0", "peak_bytes": 100},
           {"rank": 1, "device": "cuda:1", "peak_bytes": 70}])
    p.add([{"rank": 0, "device": "cuda:0", "peak_bytes": 90},
           {"rank": 1, "device": "cuda:1", "peak_bytes": 80}])
    p.add([])                                      # a one-chip job
    assert p.by_rank() == [100, 80]
    assert p.total(own=500) == 680
    assert p.fullest(own=500, own_card="cuda:0") == 600
    assert p.fullest(own=10, own_card="cuda:0") == 110
    shared = harness.RankPeaks()                   # ranks sharing a card
    shared.add([{"rank": w, "device": "cuda:0", "peak_bytes": 10}
                for w in range(4)])
    assert shared.fullest(own=5, own_card="cuda:0") == shared.total(5) == 45
    cpu = harness.RankPeaks()
    cpu.add([{"rank": 0, "device": "cpu", "peak_bytes": None}])
    assert cpu.total(own=3) == 3 and cpu.by_rank() == []


def test_command_refuses_more_chips_than_the_machine_has(monkeypatch):
    manifest = mf.load()
    cell = dict(mf.cell(manifest, WORKLOAD), name="w.x4", chips=4)
    manifest = dict(manifest, workloads=[cell])
    monkeypatch.setattr(mf, "load", lambda root=mf.ROOT: manifest)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def refuse(*a, **k):
        raise AssertionError("a run started")
    monkeypatch.setattr(harness, "run_cell", refuse)
    assert bench_run.main(["--workload", "w.x4", "--seed", "1",
                           "--seconds", "1", "--trace", "0"]) != 0


# ----------------------------------------------- the whole-list graph steps
# the steps as they were before blocks: every edge on the device at once,
# int64 throughout

def plain_simple_undirected(src, dst, n):
    keep = src != dst
    lo = torch.minimum(src[keep], dst[keep])
    hi = torch.maximum(src[keep], dst[keep])
    pairs = torch.unique(lo * n + hi)
    lo, hi = pairs // n, pairs % n
    present = torch.zeros(n, dtype=torch.bool, device=pairs.device)
    present[lo] = True
    present[hi] = True
    new_id = torch.cumsum(present, 0) - 1
    n2 = int(present.sum())
    lo, hi = new_id[lo], new_id[hi]
    keys = torch.sort(torch.cat([lo * n2 + hi, hi * n2 + lo])).values
    return graphs.Graph(torch.stack([keys // n2, keys % n2], dim=1), n2,
                        int(pairs.numel()))


def plain_relabel(g, parts, gen):
    n = g.n
    vid = torch.arange(n, device=g.edges.device)
    new_id = torch.empty_like(vid)
    for r in range(parts):
        cls = vid[r::parts]
        perm = torch.randperm(cls.numel(), generator=gen,
                              device=g.edges.device)
        new_id[cls] = cls[perm]
    e = new_id[g.edges]
    keys = torch.sort(e[:, 0] * n + e[:, 1]).values
    return graphs.Graph(torch.stack([keys // n, keys % n], dim=1), n,
                        g.listed_edges)


def plain_rmat(cfg, gen, device):
    scale = int(cfg["scale"])
    n = 2 ** scale
    m = int(cfg["edge_factor"]) * n
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for lvl in range(scale):
        r = torch.rand(m, generator=gen, device=device)
        src |= (r > a + b).long() << lvl
        dst |= (((r > a) & (r <= a + b)) | (r > a + b + c)).long() << lvl
    perm = torch.randperm(n, generator=gen, device=device)
    return plain_simple_undirected(perm[src], perm[dst], n)


def plain_uniform(cfg, gen, device):
    n, m = int(cfg["vertices"]), int(cfg["pairs"])
    src = torch.randint(0, n, (m,), generator=gen, device=device)
    dst = torch.randint(0, n, (m,), generator=gen, device=device)
    return plain_simple_undirected(src, dst, n)


def plain_make_graph(cfg, seed):
    gen = torch.Generator()
    dataset_seed = cfg.get("dataset_seed")
    gen.manual_seed(int(seed if dataset_seed is None else dataset_seed))
    make = {"rmat": plain_rmat, "uniform": plain_uniform}.get(
        cfg["generator"]) or mf.generator(cfg["generator"]).make
    g = make(cfg, gen, "cpu")
    if dataset_seed is not None:
        gen.manual_seed(int(seed))
        g = plain_relabel(g, int(cfg["partitions"]), gen)
    return g


SEEDS = [1, 7, 2 ** 31 + 5]


@pytest.mark.parametrize("blocked", [False, True],
                         ids=["one_block", "blocks"])
@pytest.mark.parametrize("scale", [8, 10, 12, 14])
def test_rmat_graphs_are_the_whole_list_steps(scale, blocked, monkeypatch):
    """Blocks of 2**(scale + 1) rows cut the draw into 8 and the stored
    edges into about 14."""
    if blocked:
        monkeypatch.setattr(graphs, "BLOCK", 2 ** (scale + 1))
    cfg = {**mf.config("graph500-22"), "scale": scale}
    for seed in SEEDS:
        want, got = plain_make_graph(cfg, seed), graphs.make_graph(
            cfg, seed, "cpu")
        assert got.edges.dtype == torch.int32
        wide = graphs.to_int64(got.edges.numpy(), "cpu")
        assert torch.equal(wide, want.edges)
        assert (got.n, got.listed_edges) == (want.n, want.listed_edges)


@pytest.mark.parametrize("config,small", [
    ("btc-14m", {"vertices": 3000, "pairs": 14000}),
    ("gage-chr14-k31", {"bases": 20000})])
def test_other_graphs_are_the_whole_list_steps(config, small, monkeypatch):
    monkeypatch.setattr(graphs, "BLOCK", 777)
    cfg = {**mf.config(config), **small}
    for seed in SEEDS:
        want, got = plain_make_graph(cfg, seed), graphs.make_graph(
            cfg, seed, "cpu")
        assert got.edges.dtype == torch.int32
        assert torch.equal(got.edges.long(), want.edges)
        assert (got.n, got.listed_edges) == (want.n, want.listed_edges)


def plain_power_iteration(edges, n, damping, iterations, dtype):
    src, dst = edges[:, 0], edges[:, 1]
    deg = torch.bincount(src, minlength=n).clamp_min(1).to(dtype)
    r = torch.full((n,), 1.0 / n, dtype=dtype, device=edges.device)
    for _ in range(iterations - 1):
        acc = torch.zeros(n, dtype=dtype, device=edges.device)
        acc.index_add_(0, dst, (r / deg)[src])
        r = (1.0 - damping) / n + damping * acc
    return r


@pytest.mark.parametrize("block", [graphs.BLOCK, 999],
                         ids=["one_block", "blocks_of_999"])
def test_blocked_reference_is_the_whole_list_iteration(block, monkeypatch):
    """On the CPU the blocks add in the whole list's order: equal bits."""
    monkeypatch.setattr(graphs, "BLOCK", block)
    g = graphs.make_graph({**mf.config("graph500-22"), "scale": 12}, 3,
                          "cpu")
    edges = graphs.to_int64(g.edges, "cpu")      # as the harness's
    for dtype in (torch.float64, torch.bfloat16):
        want = plain_power_iteration(edges, g.n, 0.85, 15, dtype)
        got = pagerank.power_iteration(edges, g.n, 0.85, 15, dtype)
        assert torch.equal(got, want)
