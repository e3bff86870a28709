#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 22] [--profile-out PATH]

Phases, each of which raises on failure (so the script exits non-zero
and never prints its last line):

1. device: the card's name and power limit; the build time of all four
   kernels (one nvcc per source, all at once); per kernel library, the
   counts of HGMMA (wgmma), UTMALDG (TMA loads) and HMMA (mma.sync) in its
   SASS; the two serving kernels must show HGMMA and UTMALDG.
2. kernel parity: each CUDA kernel against its plain torch version on the
   same CUDA tensors. The fold (sum/min/max, D = 1 to 4, ragged tiles,
   all-invalid streams, NaN/+-inf payloads, int32-max keys; the
   look-back's shapes: a segment over 66 tiles, segments of exactly 512
   rows, M = k * 512 +- 1, a key over 300,000 rows; batched (4, M) calls
   whose partitions differ in kind; a ragged (4, 1000) call where one
   partition ends in a valid row keyed int32 max, whose is_last must read
   False as the reference's padding makes it) must match
   segment_combine_blocked bit for bit, one partition at a time. The gather (V = 1, 2, 3 and 5,
   E not a multiple of 4, sorted and shuffled sources, with and without
   edge weights, pointers off the 16-byte grid) must match
   edge_gather_ref exactly. Flash
   attention at the serving prefill's shape (B*H 128, S 2048, hd 128,
   bf16, causal) and small cases (f32 and bf16, causal or not, hd 32/64/
   128, ragged S, Sq < Sk, a query block whose second warpgroup holds no
   row, GQA through strided views); the grouped matmul at the prefill (T
   65,536 rows, d 2048, f 1408 and back, 64 groups of which 60 live) and
   decode (T 32) shapes, empty groups, one group holding every row, a
   group of one row, a group that ends mid-tile before a non-empty one, T
   below one tile, d 1408, sizes summing below and above T, int32 sizes,
   f32 cases. Tolerance in the working dtype: bf16
   2**-6 |want| + 1e-3 (two units in its last place), f32 1e-5 |want| +
   2e-5.
3. graph path at the shape of LDBC Graphalytics' graph500-<scale>
   (Graph500 R-MAT, edge factor 16, P = 4 partitions on one card):
   PageRank (full_outer, 15 iterations) and SSSP from vertex 0
   (left_outer) through load_graph -> run_host -> gather_values, held to
   a scipy float64 power iteration (rtol 1e-4) and to scipy's unweighted
   shortest paths (exact). The counts are set to 0 before the path and
   read after it: the fold's and the gather's must be > 0.
4. CC and PageRank at webmap-tiny's shape (rmat 20k/240k) on the card and
   through the port's plain path on the CPU: CC equal, PageRank within
   rtol 1e-5.
5. graph kernels' timings at the graph path's shapes: kernel, plain and
   library-call ms (CUDA events, median of 20 after warm-up) beside the
   bound ms. The fold over all four partitions' (4, Ep) streams in one
   call, bit-equal to the plain fold and to itself over 20 repeats, with
   scatter_reduce over partition-offset keys as the yardstick; the
   gather over the flattened edge stream in the engine's order and
   shuffled (seeded).
6. profile: device time by kernel (torch.profiler) for the fold's one
   launch and for one PageRank and one SSSP superstep, with the device
   busy share of the wall time; ``--profile-out PATH`` also writes the
   full profiler tables to PATH.
7. reduced qwen2-moe (float32, sort dispatch), the same weights served on
   the card (kernels) and on the CPU (plain versions), TF32 off: greedy
   ids equal, logits within atol 1e-4.
8. serving path: qwen2-moe-a2.7b at full width (24 layers, d 2048, 60
   experts padded to 64, top-4, bf16, random weights from a seeded
   generator on the card) with dispatch="sort", through
   repro_torch.launch.serve.serve: batch 8, prompt 2048, 32 new tokens.
   The counts are set to 0 before the serve call and read after it: the
   flash-attention and grouped-matmul counts must be > 0. Logits finite,
   ids in range; layer 0's attention and MoE sublayers through the
   kernels vs the plain versions on the card (relative L2 <= 2**-7);
   decode vs a prefill over the prompt and the tokens generated before
   the last step: the K/V the decode steps wrote (layer 0 relative L2 <=
   2**-7, every layer <= 0.5) and the last step's logits (relative L2 <=
   0.5, bf16 drift through 24 random layers; see teacher_forced_check).
   Prints serve()'s prefill ms, decode ms a token and tokens/s, the
   same warm, and the peak of torch.cuda.max_memory_allocated. Then the
   full width cut to 2 layers in float32: every decode step's logits vs
   the teacher-forced prefill, relative L2 <= 1e-4 and the same ids.
9. serving kernels' timings at the serving path's shapes (flash: SDPA
   as the library yardstick; grouped matmul: torch._grouped_mm where
   this torch has it). The grouped matmul at prefill in both orientations
   (w_gate/w_up: d 2048 -> f 1408; w_down: d 1408 -> f 2048) and at
   decode: the kernel's wrapper alone (ms), the model's entry point
   (wrapper_ms: one launch, no other op), the host's time to enqueue one
   entry-point call (host_us, the two tensor maps' encoding included),
   and at decode the host's time for one tensor-map encode.
10. mutations and the library programs at the graph path's shape, each
   run with the counts set to 0 before it and read after it: BFS and
   Reachability from vertex 0 (left-outer + sender combine; the fold must
   launch) equal scipy's hop counts and reached set; KCore (k = 48) on
   graph500-22 made symmetric (134.2 M edge slots; fold and gather must
   launch) equals a scipy peeling to its fixed point; PathMerge (16
   rounds) on a 2**22-vertex chain equals the port's CPU path bit for
   bit (run in a child process started after the build, so that it
   overlaps the card phases), conserves its mass, and launches the
   gather; an insert program at the default mutation_cap regrows it and
   lands on its closed form; a custom (selection) combine at webmap-
   tiny's shape, sender combine on and off, equals the CPU path. Prints
   each run's supersteps, median superstep s and launches, k, the core's
   size, the survivors and the regrow events.
11. checkpoints and recovery at graph500-20 (its own graph, its own
   uninterrupted runs and scipy references; at -22 the snapshots' zlib
   took a quarter of the script): SSSP with checkpoint_every=3 and
   recover=True, a one-shot WorkerFailure(1) after superstep 5: one
   recovery event, the superstep-3 snapshot restored onto 3 partitions,
   distances equal scipy's and the uninterrupted run's. PageRank with a
   snapshot at superstep 10: save -> load bit-equal in every field;
   resumed from it, ranks within rtol 1e-5 of the uninterrupted run and
   1e-4 of scipy. Prints the scale and the seconds of each save
   (savez_compressed, then its CRC), each CRC check, load and
   repartition, with the snapshot bytes.
12. the cost-based planner: the machine model's bandwidths measured on
   the card (a 2 GiB device copy, pinned host<->device copies, a host
   numpy copy) beside the committed H100_MACHINE; calibrate_machine at
   graph500-<scale>'s statistics (seconds, fitted constants inside their
   clamps); PageRank (15 iterations) and SSSP from vertex 0 under
   plan="auto", held to scipy as in phase 3, with the initial plan, every
   plan switch, supersteps, median superstep s and run s beside phase 3's
   static medians, and the launches of the kernels the plans call for;
   SSSP from the corner of grid_graph(1024) (1,048,576 vertices,
   4,190,208 directed edges, diameter 2046) under plan="auto" (at least
   one plan switch, ending left-outer) and under SSSP.suggested_plan,
   both equal to row + col at every vertex. The counts are set to 0
   before each run and read after it.
13. out-of-core: repro_torch.core.ooc.run_out_of_core with the graph
   loaded on the host (P = 8) and 2 partitions on the card at a time
   (four super-partitions). At graph500-<scale>, the pure-DRAM tier,
   streamed and barrier-free: PageRank (15 iterations, full-outer)
   within rtol 1e-4 of phase 3's scipy power iteration and 1e-5 of
   phase 3's run_host ranks, fold and gather launched; SSSP from vertex
   0 equal to scipy's hop counts, the fold launched; the peak of
   max_memory_allocated beside one super-partition's vertex block. At
   graph500-20 (phase 11's graph): PageRank streamed with a checkpoint
   at superstep 10; synchronous, on the disk tier (a third of the
   streamed run's peak pager bytes, mru, one I/O thread) and resumed
   from the checkpoint, each within rtol 1e-5 of the streamed run (bit
   equality printed); SSSP under plan="auto" equal to scipy, with its
   plans. Prints each run's supersteps, median superstep s, run s,
   median readiness stall, dispatch / collect-wait / commit seconds and
   launches, the disk tier's hit rate and spill bytes, and the device
   busy share of one streamed superstep (torch.profiler). The counts
   are set to 0 before each run and read after it.

Before its last line it prints its total seconds, the card's nvidia-smi
line and one JSON line with every kernel's name, route, source, the TPU
kernel it replaces, its launches on its main path (and, for the graph
kernels, on phase 12's and phase 13's runs), max abs err, kernel / plain / bound /
library ms. The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()   # main() resets it: the script's total seconds
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM, NVIDIA's data sheet: HBM3 bandwidth
MEM_BYTES_PER_S = 3.35e12
FOLD_SRC = "src/repro_torch/kernels/csrc/segment_combine.cu"
GATHER_SRC = "src/repro_torch/kernels/csrc/csr_spmv.cu"
FOLD_REPLACES = "src/repro/kernels/segment_combine/segment_combine.py:80"
GATHER_REPLACES = "src/repro/kernels/csr_spmv/csr_spmv.py:38"
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
GMM_SRC = "src/repro_torch/kernels/csrc/moe_gmm.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:75"
GMM_REPLACES = "src/repro/kernels/moe_gmm/moe_gmm.py:31"
P = 4
# the serving path's shapes: qwen2-moe-a2.7b at batch 8, prompt 2048; its
# prefill's attention (B*H, S, hd) and its grouped matmul's routed rows
# (prefill B*S*top_k, decode B*top_k) over 64 expert groups, 60 live
SERVE_SHAPE = dict(BH=128, S=2048, hd=128, T_pre=65536, T_dec=32, d=2048,
                   f=1408, E=64, live=60)
# the kernels each main path must launch
GRAPH_KERNELS = ("segment_combine", "csr_spmv")
SERVING_KERNELS = ("flash_attention", "moe_gmm")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else \
        f"nvidia-smi failed: {out.stderr.strip()}"


# ------------------------------------------------------------- comparisons

def same_bits(a, b) -> bool:
    """float32 tensors equal bit for bit (so -0.0 != +0.0), NaN where
    the other has NaN (torch picks a NaN's payload by code path)."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    bits = lambda x, n: torch.where(n, 0, x.view(torch.int32))
    return torch.equal(bits(a, na), bits(b, nb))


def max_abs_err(a, b) -> float:
    import torch
    ok = torch.isfinite(a) & torch.isfinite(b)
    if not bool(ok.any()):
        return 0.0
    return float((a[ok] - b[ok]).abs().max())


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn`` on the card: CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ------------------------------------------------------------- references

def pagerank_reference(edges: np.ndarray, n: int, iterations: int,
                       damping: float = 0.85) -> np.ndarray:
    """float64 power iteration of the port's PageRank update: duplicate
    edges counted, out-degree max(deg, 1), dangling mass dropped,
    superstep 0 keeps 1/n, then iterations - 1 updates."""
    from scipy.sparse import csr_matrix
    src, dst = edges[:, 0], edges[:, 1]
    deg = np.maximum(np.bincount(src, minlength=n), 1).astype(np.float64)
    A = csr_matrix((np.ones(len(src)), (dst, src)), shape=(n, n))
    r = np.full(n, 1.0 / n)
    for _ in range(iterations - 1):
        r = (1.0 - damping) / n + damping * (A @ (r / deg))
    return r


def sssp_reference(edges: np.ndarray, n: int, source: int) -> np.ndarray:
    """Unit-weight shortest paths from ``source`` (inf = unreached)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path
    A = csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                   shape=(n, n))
    return shortest_path(A, directed=True, unweighted=True, indices=source)


# ------------------------------------------------------------- phase 2

def fold_case(rng, M: int, D: int, kind: str, device):
    """A key-sorted stream of M rows with its invalid rows at the tail."""
    import torch
    n_valid = 0 if kind == "all_invalid" else int(M * 0.9) or M
    keys = np.sort(rng.integers(0, max(M // 8, 2), n_valid)).astype(np.int64)
    if kind == "int32max":
        keys[-max(n_valid // 10, 1):] = 2 ** 31 - 1
    keys = np.concatenate([keys, np.full(M - n_valid, 2 ** 31 - 1)])
    pay = rng.normal(size=(M, D)).astype(np.float32)
    if kind == "nonfinite":
        pick = rng.random((M, D))
        pay[pick < 0.03] = np.inf
        pay[(pick >= 0.03) & (pick < 0.06)] = -np.inf
        pay[(pick >= 0.06) & (pick < 0.09)] = np.nan
    valid = np.arange(M) < n_valid
    t = lambda a: torch.from_numpy(a).to(device)
    return t(keys.astype(np.int32)), t(pay), t(valid)


def fold_ragged_int32max(rng, M: int, D: int, device):
    """A ragged stream whose rows are all valid and whose last rows are
    keyed int32 max: the reference pads the stream with int32-max keys,
    so is_last of its last row reads False."""
    import torch
    keys = np.sort(rng.integers(0, max(M // 6, 2), M)).astype(np.int32)
    keys[-5:] = 2 ** 31 - 1
    t = lambda a: torch.from_numpy(a).to(device)
    return t(keys), t(rng.normal(size=(M, D)).astype(np.float32)), \
        t(np.ones(M, bool))


def fold_runs(rng, lens, D: int, kind: str, device):
    """A stream of runs of equal keys with the given lengths (keys 1, 4,
    7, ...), a few invalid rows at the tail (all of them for
    kind="all_invalid"), and NaN/+-inf payloads for kind="nonfinite"."""
    import torch
    M = int(sum(lens))
    keys = np.repeat(np.arange(len(lens)) * 3 + 1, lens).astype(np.int32)
    n_valid = 0 if kind == "all_invalid" else M - int(rng.integers(0, 40))
    keys[n_valid:] = 2 ** 31 - 1
    pay = rng.normal(size=(M, D)).astype(np.float32)
    if kind == "nonfinite":
        pick = rng.random((M, D))
        pay[pick < 0.01] = np.inf
        pay[(pick >= 0.01) & (pick < 0.02)] = -np.inf
        pay[(pick >= 0.02) & (pick < 0.025)] = np.nan
    t = lambda a: torch.from_numpy(a).to(device)
    return t(keys), t(pay), t(np.arange(M) < n_valid)


def lookback_lens(rng, shape: str):
    """Run lengths that exercise the look-back at BM = 512: one segment
    over 66 tiles, segments of exactly BM rows (tile-aligned, then not),
    M = k * BM - 1 and k * BM + 1, a key repeated over 300,000 rows."""
    BM = 512
    if shape == "span_over_64_tiles":
        return [37, 1200, 66 * BM + 5, 300, 811]
    if shape == "span_exactly_bm":
        return [BM, BM, 100, BM, BM, 412, BM, 3]
    if shape == "k_bm_minus_1":
        lens = list(rng.integers(1, 10, 200)) + [2 * BM]
        lens[-1] += 7 * BM - 1 - sum(lens)
        return lens
    if shape == "k_bm_plus_1":
        lens = [3 * BM + 1] + list(rng.integers(1, 30, 100))
        lens[-1] += 10 * BM + 1 - sum(lens)
        return lens
    assert shape == "key_over_300k_rows"
    return list(rng.geometric(0.1, 2000)) + [300_000] + \
        list(rng.geometric(0.1, 2000))


def plain_fold(keys, pay, valid, op):
    """segment_combine_blocked, once per partition of a (P, M) call."""
    import torch
    from repro_torch.kernels.segment_combine import segment_combine_blocked
    if keys.dim() == 1:
        return segment_combine_blocked(keys, pay, valid, op, block_m=512)
    outs = [segment_combine_blocked(keys[p], pay[p], valid[p], op,
                                    block_m=512)
            for p in range(keys.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1]
                                                           for o in outs])


def check_fold(keys, pay, valid, op, what: str = ""):
    from repro_torch.kernels.segment_combine import segment_combine
    got, last_k = segment_combine(keys, pay, valid, op, block_m=512)
    want, last_p = plain_fold(keys, pay, valid, op)
    if not (same_bits(got, want) and bool((last_k == last_p).all())):
        raise AssertionError(
            f"segment_combine {op} {what} shape {tuple(pay.shape)}: kernel "
            f"!= plain (max abs err {max_abs_err(got, want)})")
    return max_abs_err(got, want)


def fold_parity(device) -> float:
    """The fold against segment_combine_blocked, bit for bit: one-stream
    calls (P = 1) over random and edge-case streams, the look-back's
    shapes, and batched (P = 4) calls whose partitions differ in kind
    (one all invalid)."""
    import torch
    rng = np.random.default_rng(0)
    err = 0.0
    for op in ("sum", "min", "max"):
        for D in (1, 2):
            for M in (1, 300, 512, 1500, 100_003):
                for kind in ("plain", "all_invalid", "nonfinite",
                             "int32max"):
                    err = max(err, check_fold(*fold_case(rng, M, D, kind,
                                                         device), op))
            for shape in ("span_over_64_tiles", "span_exactly_bm",
                          "k_bm_minus_1", "k_bm_plus_1",
                          "key_over_300k_rows"):
                for kind in ("plain", "nonfinite"):
                    case = fold_runs(rng, lookback_lens(rng, shape), D, kind,
                                     device)
                    err = max(err, check_fold(*case, op, shape))
            for M in (7, 1500, 3 * 512 + 1, 100_003):
                parts = [fold_case(rng, M, D, kind, device) for kind in
                         ("plain", "all_invalid", "nonfinite", "int32max")]
                batch = [torch.stack([c[i] for c in parts]) for i in
                         range(3)]
                err = max(err, check_fold(*batch, op, "batched"))
        # a stream that is one key over 300,000 rows in all 4 partitions,
        # and the widest payloads the kernel takes
        lens = lookback_lens(rng, "key_over_300k_rows")
        parts = [fold_runs(rng, lens, 1, "plain", device) for _ in range(4)]
        batch = [torch.stack([c[i] for c in parts]) for i in range(3)]
        err = max(err, check_fold(*batch, op, "batched 300k-row key"))
        for D in (3, 4):
            err = max(err, check_fold(*fold_case(rng, 5000, D, "nonfinite",
                                                 device), op, f"D={D}"))
        # a ragged (4, 1000) call where only partition 1 ends in a valid
        # row keyed int32 max (is_last False there, as in the reference)
        for D in (1, 3):
            parts = [fold_case(rng, 1000, D, kind, device) for kind in
                     ("plain", "int32max", "all_invalid", "nonfinite")]
            parts[1] = fold_ragged_int32max(rng, 1000, D, device)
            batch = [torch.stack([c[i] for c in parts]) for i in range(3)]
            err = max(err, check_fold(*batch, op, "ragged int32-max end"))
            if bool(plain_fold(*batch, op)[1][1, -1]):
                raise AssertionError("plain fold: is_last of a ragged "
                                     "stream's int32-max last row")
    return err


def gather_case(rng, N: int, V: int, E: int, device, order: str):
    """values with +-inf and NaN; E sources, 10 % of them -1, in engine
    order (sorted, as load_graph stores a partition's edges) or shuffled;
    edge weights."""
    import torch
    values = rng.normal(size=(N, V)).astype(np.float32)
    pick = rng.random((N, V))
    values[pick < 0.02] = np.inf
    values[(pick >= 0.02) & (pick < 0.04)] = -np.inf
    values[(pick >= 0.04) & (pick < 0.06)] = np.nan
    src = rng.integers(0, N, E).astype(np.int32)
    if order == "sorted":
        src = np.sort(src)
    src[rng.random(E) < 0.1] = -1
    ev = rng.normal(size=E).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)
    return t(values), t(src), t(ev)


def check_gather(values, src, ev, what: str = ""):
    from repro_torch.kernels.csr_spmv import edge_gather, edge_gather_ref
    got = edge_gather(values, src, ev)
    want = edge_gather_ref(values, src, ev)
    if not same_bits(got, want):
        raise AssertionError(
            f"csr_spmv {what} N={values.shape[0]} V={values.shape[1]} "
            f"E={src.shape[0]}: kernel != plain (max abs err "
            f"{max_abs_err(got, want)})")
    return max_abs_err(got, want)


def gather_parity(device) -> float:
    """The gather against edge_gather_ref, exactly: V = 1, 2, 3 (the
    vector path), 5 (the scalar one), E not a multiple of 4, sorted and
    shuffled sources, with and without edge weights, and sources and
    weights that start off the 16-byte grid (the scalar path)."""
    rng = np.random.default_rng(1)
    err = 0.0
    for V in (1, 2, 3, 5):
        for N, E in ((1, 5), (300, 1001), (1000, 20_003),
                     (100_001, 1_000_003)):
            for order in ("sorted", "shuffled"):
                values, src, ev = gather_case(rng, N, V, E, device, order)
                what = f"{order} V={V}"
                err = max(err, check_gather(values, src, ev, what))
                err = max(err, check_gather(values, src, None, what))
                err = max(err, check_gather(values, src[1:], ev[1:],
                                            what + " misaligned"))
    return err


# ------------------------------------------------------------- main

def run_main_path(edges, n, device, stats_out: dict):
    """PageRank + SSSP through the port's entry points on ``device``."""
    import torch
    from repro_torch.core import gather_values, load_graph, run_host
    from repro_torch.graph import SSSP, PageRank
    out = {}
    for name, prog, vd in (("pagerank", PageRank(n, iterations=15), 2),
                           ("sssp", SSSP(source=0), 1)):
        vert = load_graph(edges, n, P, value_dims=vd, device=device)
        sync = torch.cuda.synchronize if device == "cuda" else \
            (lambda: None)
        sync()
        t0 = time.perf_counter()
        res = run_host(vert, prog, prog.suggested_plan, max_supersteps=60)
        sync()
        walls = [s["wall_s"] for s in res.stats if "wall_s" in s]
        stats_out[name] = dict(
            supersteps=res.supersteps, run_s=time.perf_counter() - t0,
            superstep_median_s=statistics.median(walls),
            superstep_median_after_first_s=(statistics.median(walls[1:])
                                            if len(walls) > 1 else None),
            events=[s["event"] for s in res.stats if "event" in s])
        out[name] = gather_values(res.vertex, n)
        del vert, res
        free(device)
    return out


def check_main_path(values, edges, n):
    """-> (scipy PageRank, scipy hop counts), for the later phases."""
    from repro_torch.graph.algorithms import INF
    pr = values["pagerank"][:, 0].astype(np.float64)
    ref = pagerank_reference(edges, n, 15)
    rel = np.abs(pr - ref) / np.abs(ref)
    log(f"pagerank vs scipy float64: max rel err {rel.max():.3e}")
    if not np.allclose(pr, ref, rtol=1e-4, atol=0):
        raise AssertionError(f"pagerank off the reference: max rel err "
                             f"{rel.max():.3e}")
    dist = values["sssp"][:, 0]
    hops = sssp_reference(edges, n, 0)
    want = np.where(np.isinf(hops), np.float32(INF), hops).astype(np.float32)
    bad = int((dist != want).sum())
    log(f"sssp vs scipy shortest_path: {bad} of {n} vertices differ; "
        f"{int(np.isfinite(hops).sum())} reached")
    if bad:
        raise AssertionError(f"sssp differs from scipy at {bad} vertices")
    return ref, hops


def card_vs_cpu():
    from repro_torch.core import gather_values, load_graph, run_host
    from repro_torch.graph import ConnectedComponents, PageRank, rmat_graph
    n = 20_000
    edges = rmat_graph(n, 240_000, seed=1)
    got = {}
    for dev in ("cuda", "cpu"):
        for name, prog, vd in (("cc", ConnectedComponents(), 1),
                               ("pagerank", PageRank(n, iterations=15), 2)):
            vert = load_graph(edges, n, P, value_dims=vd, device=dev)
            res = run_host(vert, prog, prog.suggested_plan,
                           max_supersteps=60)
            got[(dev, name)] = (gather_values(res.vertex, n),
                                res.supersteps)
    if not np.array_equal(got[("cuda", "cc")][0], got[("cpu", "cc")][0]) \
            or got[("cuda", "cc")][1] != got[("cpu", "cc")][1]:
        raise AssertionError("CC on the card differs from the CPU path")
    a, b = got[("cuda", "pagerank")][0], got[("cpu", "pagerank")][0]
    if not np.allclose(a, b, rtol=1e-5, atol=0):
        raise AssertionError("PageRank on the card differs from the CPU "
                             f"path: max abs err {np.abs(a - b).max()}")
    log(f"webmap-tiny shape: CC equal card/CPU in "
        f"{got[('cuda', 'cc')][1]} supersteps; PageRank max abs err "
        f"{float(np.abs(a - b).max()):.3e}")


# ------------------------------------------------------------- timings

def fold_inputs(vert, seed: int = 5):
    """The sender fold's inputs at the main path's shape: every
    partition's edge stream (P, Ep) keyed by its dst vids, stably sorted
    per partition, invalid slots int32 max at the tail; payload (P, Ep,
    1) uniform from a seeded generator."""
    import torch
    key = torch.where(vert.edge_src >= 0, vert.edge_dst, 2 ** 31 - 1)
    key = torch.sort(key, dim=1, stable=True).values
    g = torch.Generator(device=key.device).manual_seed(seed)
    pay = torch.rand(key.shape + (1,), generator=g, device=key.device)
    return key, pay, key != 2 ** 31 - 1


def fold_timing(vert, launches: int) -> dict:
    """The sender fold at the main path's shape, all P partitions in one
    call (one launch): bit-equal to the plain fold, and to itself over 20
    repeats (a look-back race would show as bits that change)."""
    import torch
    from repro_torch.kernels.segment_combine import segment_combine
    key, pay, valid = fold_inputs(vert)
    Pn, M = key.shape
    run_k = lambda: segment_combine(key, pay, valid, "sum", block_m=512)
    run_p = lambda: plain_fold(key, pay, valid, "sum")
    got, last = run_k()
    want, wlast = run_p()
    if not (same_bits(got, want) and torch.equal(last, wlast)):
        raise AssertionError("segment_combine at the main-path shape: "
                             "kernel != plain")
    err = max_abs_err(got, want)
    del want, wlast
    for i in range(20):
        again, alast = run_k()
        if not (same_bits(again, got) and torch.equal(alast, last)):
            raise AssertionError(f"segment_combine at the main-path shape: "
                                 f"repeat {i} differs from the first call")
    del again, alast
    # the yardstick: scatter_reduce of every partition's valid rows (an
    # invalid row adds nothing) in one call, the keys offset by partition
    # (p * 2**32 + dst) and numbered in order
    off = torch.arange(Pn, device=key.device, dtype=torch.int64)[:, None]
    uniq, inv, counts = torch.unique_consecutive(
        (off << 32 | key.long()).reshape(-1), return_inverse=True,
        return_counts=True)
    longest = int(counts[(uniq & 0xffffffff) != 2 ** 31 - 1].max())
    n_seg = int(inv.max()) + 1
    ok = valid.reshape(-1)
    idx, vpay = inv[ok][:, None], pay.reshape(-1, 1)[ok]
    del inv
    run_l = lambda: torch.zeros((n_seg, 1), device=key.device) \
        .scatter_reduce_(0, idx, vpay, "sum", include_self=False)
    ms = time_ms(run_k)
    plain_ms = time_ms(run_p, reps=3, warmup=1)
    lib_ms = time_ms(run_l)
    # where the time goes: each partition's stream alone, and its tiles
    # with no valid row (its invalid tail)
    parts = [(key[p:p + 1].contiguous(), pay[p:p + 1].contiguous(),
              valid[p:p + 1].contiguous()) for p in range(Pn)]
    per_part = [time_ms(lambda: segment_combine(*a, "sum", block_m=512))
                for a in parts]
    tiles = -(-M // 512)
    pad = tiles * 512 - M
    tail = (~torch.nn.functional.pad(valid, (0, pad)).reshape(Pn, tiles, 512)
            .any(-1)).sum(-1).tolist()
    del parts
    # keys, payload and valid read; folded payload and is_last written
    nbytes = Pn * M * (4 + 4 + 1) + Pn * M * (4 + 1)
    return dict(name="segment_combine", route="cuda", source=FOLD_SRC,
                replaces=FOLD_REPLACES, launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / MEM_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=lib_ms, repeats_identical=20,
                per_partition_ms=per_part,
                shape=dict(P=Pn, M=M, D=1, tiles=Pn * tiles,
                           tail_tiles=tail,
                           valid=valid.sum(-1).tolist(),
                           longest_segment=longest))


def gather_timing(vert, launches: int) -> dict:
    """The edge gather at the main path's shape: all P partitions' edges
    in one stream over PageRank's (P * Np, 2) values, in the engine's
    order (each partition's edges sorted by source slot), and the same
    sources in a seeded random order (the case a row blocking is for)."""
    import torch
    from repro_torch.kernels.csr_spmv import edge_gather, edge_gather_ref
    Pn, Np = vert.vid.shape
    dev = vert.vid.device
    off = (torch.arange(Pn, dtype=torch.int32, device=dev) * Np)[:, None]
    src = torch.where(vert.edge_src >= 0, vert.edge_src + off, -1) \
        .reshape(-1)
    g = torch.Generator(device=dev).manual_seed(6)
    values = torch.rand((Pn * Np, 2), generator=g, device=dev)
    values[::97, 0] = float("inf")
    values[::89, 1] = float("nan")
    shuffled = src[torch.randperm(src.shape[0], generator=g, device=dev)]
    res = {}
    for name, s in (("sorted", src), ("shuffled", shuffled)):
        run_k = lambda: edge_gather(values, s, None)
        run_p = lambda: edge_gather_ref(values, s, None)
        got, want = run_k(), run_p()
        if not same_bits(got, want):
            raise AssertionError(f"csr_spmv at the main-path shape "
                                 f"({name} sources): kernel != plain")
        err = max_abs_err(got, want)
        del got, want
        ok = (s >= 0)[:, None]
        idx = s.clamp(min=0).long()
        run_l = lambda: torch.where(ok, values.index_select(0, idx), 0.0)
        res[name] = dict(ms=time_ms(run_k), plain_ms=time_ms(run_p),
                         library_ms=time_ms(run_l), max_abs_err=err)
        del ok, idx
    E, V = src.shape[0], values.shape[1]
    # the function's bytes: src and values read, the output written
    nbytes = E * 4 + values.numel() * 4 + E * V * 4
    return dict(name="csr_spmv", route="cuda", source=GATHER_SRC,
                replaces=GATHER_REPLACES, launches=launches,
                **res["sorted"], bound_ms=nbytes / MEM_BYTES_PER_S * 1e3,
                bound_by="bytes", shuffled=res["shuffled"],
                shape=dict(E=E, rows=values.shape[0], V=V,
                           valid=int((src >= 0).sum())))


def _device_ms(evt) -> float:
    t = getattr(evt, "device_time_total", None)
    if t is None:
        t = evt.cuda_time_total
    return t / 1e3


def profile_kernels(fn, reps: int, out_path, title: str) -> dict:
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler
    with CUDA activity), per call, plus the device busy share of the
    host wall time and the device kernels run a call. The full table is
    appended to ``out_path`` if set."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kern = [e for e in prof.key_averages()
            if _device_ms(e) > 0 and e.device_type.name == "CUDA"]
    kern.sort(key=_device_ms, reverse=True)
    busy_ms = sum(_device_ms(e) for e in kern) / reps
    kernels = sum(e.count for e in kern) / reps
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "a") as f:
            f.write(f"== {title}: wall {wall_ms:.3f} ms/call, device busy "
                    f"{busy_ms:.3f} ms/call\n")
            f.write(prof.key_averages().table(row_limit=60))
            f.write("\n")
    top = [(e.key[:60], round(_device_ms(e) / reps, 4)) for e in kern[:8]]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms if wall_ms else None,
                kernels_per_call=kernels, top=top)


def profile_phase(vert, n, out) -> dict:
    """Where the time goes: the fold's one launch over all partitions at
    the main path's shape, and one PageRank / SSSP superstep at graph500
    scale."""
    import torch
    from repro_torch.core.driver import prepare_run
    from repro_torch.core.superstep import make_superstep
    from repro_torch.graph import SSSP, PageRank
    from repro_torch.kernels.segment_combine import segment_combine
    if out is not None and out.exists():
        out.unlink()
    key, pay, valid = fold_inputs(vert)
    res = {"fold": profile_kernels(
        lambda: segment_combine(key, pay, valid, "sum", block_m=512), 5,
        out, "segment_combine at the main-path shape, all partitions")}
    del key, pay, valid
    for name, prog in (("pagerank_superstep", PageRank(n, iterations=15)),
                       ("sssp_superstep", SSSP(source=0))):
        v = dataclasses.replace(vert, value=vert.value[..., :prog.value_dims]
                                .contiguous())
        ec, v, m, g = prepare_run(v, prog, prog.suggested_plan, None)
        step = make_superstep(prog, prog.suggested_plan, ec)
        state = step(v, m, g)              # superstep 0: every vertex sends
        res[name] = profile_kernels(lambda: step(*state), 3, out,
                                    f"{name} (superstep 1, repeated)")
        del state, v, m, g
        torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------- phase 10

KCORE_K = 48     # graph500-22 made symmetric: neither empty nor whole
CHAIN_SCALE = 22  # PathMerge's chain: 2**22 k-mer vertices
CKPT_SCALE = 20   # phase 11's graph500 scale


def free(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reset_counters():
    from repro_torch.kernels import COUNTERS
    for c in COUNTERS.values():
        c.reset()


def drive(prog, edges, n, vd, device, plan=None, **kw):
    """One run of ``prog`` through load_graph -> run_host on ``device``,
    with the counts set to 0 just before run_host and read just after.
    -> (RunResult, stats dict with the launches of this run)."""
    import torch
    from repro_torch.core import load_graph, run_host
    from repro_torch.kernels import COUNTERS
    vert = load_graph(edges, n, P, value_dims=vd, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    reset_counters()
    t0 = time.perf_counter()
    res = run_host(vert, prog, plan or prog.suggested_plan,
                   max_supersteps=kw.pop("max_supersteps", 100), **kw)
    sync()
    run_s = time.perf_counter() - t0
    walls = [st["wall_s"] for st in res.stats if "wall_s" in st]
    return res, dict(
        supersteps=res.supersteps, run_s=run_s,
        superstep_median_s=statistics.median(walls) if walls else None,
        events=[st["event"] for st in res.stats if "event" in st],
        launches={k: c.launches for k, c in COUNTERS.items()})


def need_launches(what: str, stats: dict, names, device):
    """The kernels that ``what`` must have launched on the card (on the
    CPU the plain versions run and nothing launches)."""
    if device != "cuda":
        return
    for k in names:
        if stats["launches"][k] <= 0:
            raise AssertionError(f"kernel {k} never launched on {what}")


def kcore_reference(edges: np.ndarray, n: int, k: int) -> np.ndarray:
    """Synchronous peeling to a fixed point over the symmetric multigraph
    of ``edges`` (each edge both ways, multiplicities kept): alive &=
    (A + A^T) @ alive >= k. Every sum is a sum of integers."""
    from scipy.sparse import csr_matrix
    A = csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                   shape=(n, n))
    alive = np.ones(n, bool)
    while True:
        a = alive.astype(np.float64)
        nxt = alive & (A @ a + A.T @ a >= k)
        if np.array_equal(nxt, alive):
            return alive
        alive = nxt


def same_relation(a, b) -> bool:
    """Two VertexRels equal field for field (floats bit for bit)."""
    import torch
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name).cpu(), getattr(b, f.name).cpu()
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if not (same_bits(x, y) if x.dtype == torch.float32 else
                torch.equal(x, y)):
            return False
    return True


def insert_program(n: int, shift: int = 3):
    """Every vertex proposes at superstep 0 an insert of (vid + shift) % n
    with value vid + 1000 (the reference's CrossInsert test program):
    every existing vertex receives exactly one proposal, so its value
    becomes ((v - shift) mod n) + 1000, exactly (< 2**24)."""
    import torch
    from repro_torch.core import ComputeOut, PhysicalPlan, VertexProgram

    class InsertShift(VertexProgram):
        value_dims = 1
        msg_dims = 1
        agg_dims = 1
        combine_op = "sum"
        mutates = True
        suggested_plan = PhysicalPlan(join="full_outer", groupby="scatter")

        def init_value(self, vid, out_degree, gs):
            return torch.where(vid >= 0, vid, 0).float()[..., None]

        def compute(self, vid, value, msg, has_msg, active, gs):
            first = gs.superstep == 0
            tgt = torch.where(first & (vid >= 0), (vid + shift) % n, -1)
            return ComputeOut(
                value=value, halt=(~first).expand(vid.shape),
                send_gate=torch.zeros_like(first).expand(vid.shape),
                aggregate=torch.zeros(vid.shape + (1,), device=vid.device),
                insert_vid=tgt,
                insert_value=torch.where(vid >= 0, vid, 0)
                .float()[..., None] + 1000.0)

        def send(self, src_vid, src_value, edge_val, dst_vid, gs):
            return torch.zeros_like(src_value[..., 0:1])

    return InsertShift()


def min_label_program():
    """Label propagation with a witness under a custom combine: value =
    [label, the vid that sent it], a message (label, sender); the combine
    selects the row with the smaller label (the earlier one on a tie), so
    it is exact in any bracketing."""
    import torch
    from repro_torch.core import ComputeOut, VertexProgram
    from repro_torch.graph.algorithms import INF

    class MinLabel(VertexProgram):
        value_dims = 2
        msg_dims = 2
        agg_dims = 1
        combine_op = "custom"

        def combine_identity(self):
            return torch.full((2,), float("inf"))

        def combine(self, a, b):
            return torch.where(a[..., 0:1] <= b[..., 0:1], a, b)

        def init_value(self, vid, out_degree, gs):
            lab = torch.where(vid >= 0, vid, 0).float()
            return torch.stack([lab, lab], -1)

        def compute(self, vid, value, msg, has_msg, active, gs):
            cur = value[..., 0]
            inc = torch.where(has_msg, msg[..., 0], INF)
            better = inc < cur
            new = torch.stack([torch.where(better, inc, cur),
                               torch.where(better, msg[..., 1],
                                           value[..., 1])], -1)
            send = better | (gs.superstep == 0)
            return ComputeOut(value=new, halt=torch.ones_like(send),
                              send_gate=send,
                              aggregate=torch.zeros(vid.shape + (1,),
                                                    device=vid.device))

        def send(self, src_vid, src_value, edge_val, dst_vid, gs):
            return torch.stack([src_value[..., 0], src_vid.float()], -1)

    return MinLabel()


def path_merge_cpu(out_path: str, scale: int):
    """The port's CPU path of phase 10's PathMerge run on a 2**scale
    chain, in a process of its own (``chip_smoke.py --path-merge-cpu OUT
    SCALE``) so that it overlaps the card phases: writes the final vertex
    relation and the run's supersteps and seconds to OUT (npz)."""
    import torch
    from repro_torch.core import vertex_to_numpy
    from repro_torch.graph import PathMerge, chain_graph
    torch.set_num_threads(4)
    nc = 2 ** scale
    res, st = drive(PathMerge(rounds=16), chain_graph(nc), nc, 2, "cpu")
    np.savez(out_path, supersteps=res.supersteps, run_s=st["run_s"],
             **vertex_to_numpy(res.vertex))


class PathMergeChild:
    """``path_merge_cpu`` in a child process, started after the build and
    joined in phase 10; ``stop`` ends it whatever happened."""

    def __init__(self, tmpdir: str):
        self.out = str(Path(tmpdir) / "path_merge_cpu.npz")
        self.err = open(Path(tmpdir) / "path_merge_cpu.err", "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--path-merge-cpu", self.out, str(CHAIN_SCALE)],
            stdout=subprocess.DEVNULL, stderr=self.err)

    def result(self):
        """-> (VertexRel on the CPU, supersteps, run s, wait s)."""
        from repro_torch.core import vertex_from_numpy
        t = time.perf_counter()
        rc = self.proc.wait(timeout=900)
        waited = time.perf_counter() - t
        if rc != 0:
            self.err.seek(0)
            raise AssertionError(f"PathMerge CPU process failed ({rc}): "
                                 f"{self.err.read()[-2000:]}")
        z = dict(np.load(self.out))
        return (vertex_from_numpy(z, "cpu"), int(z["supersteps"]),
                float(z["run_s"]), waited)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.err.close()


def mutations_and_programs(edges, n, hops, path_merge_child=None, *,
                           device="cuda", k=KCORE_K,
                           chain_scale=CHAIN_SCALE) -> dict:
    """Phase 10 at the graph path's shape: BFS and Reachability from
    vertex 0 held to scipy's hop counts, KCore on the symmetric graph held
    to a scipy peeling, PathMerge on a 2**22-vertex chain card vs the
    port's CPU path (``path_merge_child``'s, else run here), an insert
    program held to its closed form, and a custom combine card vs CPU at
    webmap-tiny's shape. ``device="cpu"`` rehearses it on the plain
    path."""
    from repro_torch.core import PhysicalPlan, gather_values
    from repro_torch.graph import (BFS, KCore, PathMerge, Reachability,
                                   chain_graph, rmat_graph)
    from repro_torch.graph.algorithms import INF
    out = {}
    reached = np.isfinite(hops)
    want_lv = np.where(reached, hops, np.float32(INF)).astype(np.float32)

    # BFS and Reachability, left-outer + sender combine
    res, st = drive(BFS(0), edges, n, 1, device)
    need_launches("BFS", st, ("segment_combine",), device)
    lv = gather_values(res.vertex, n)[:, 0]
    bad = int((lv != want_lv).sum())
    if bad:
        raise AssertionError(f"BFS differs from scipy at {bad} vertices")
    out["bfs"] = st
    del res
    res, st = drive(Reachability(0), edges, n, 1, device)
    need_launches("Reachability", st, ("segment_combine",), device)
    got = gather_values(res.vertex, n)[:, 0] > 0
    if not np.array_equal(got, reached):
        raise AssertionError("Reachability differs from scipy at "
                             f"{int((got != reached).sum())} vertices")
    out["reachability"] = dict(st, reached=int(got.sum()))
    del res
    free(device)
    log(f"phase 10: BFS {json.dumps(out['bfs'])}; reachability "
        f"{json.dumps(out['reachability'])}")

    # KCore on the symmetric multigraph (134 M directed edge slots)
    t = time.perf_counter()
    sym = np.concatenate([edges, edges[:, ::-1]])
    res, st = drive(KCore(k), sym, n, 2, device)
    del sym
    need_launches("KCore", st, ("segment_combine", "csr_spmv"), device)
    alive = gather_values(res.vertex, n)[:, 1] > 0
    del res
    free(device)
    t_ref = time.perf_counter()
    want = kcore_reference(edges, n, k)
    ref_s = time.perf_counter() - t_ref
    if not 0 < want.sum() < n:
        raise AssertionError(f"k = {k}: core of {int(want.sum())} "
                             f"of {n} vertices")
    if not np.array_equal(alive, want):
        raise AssertionError(f"KCore differs from the scipy peeling at "
                             f"{int((alive != want).sum())} vertices")
    out["kcore"] = dict(st, k=k, core=int(alive.sum()),
                        oracle_s=ref_s, phase_s=time.perf_counter() - t)
    log(f"phase 10: KCore {json.dumps(out['kcore'])}")

    # PathMerge (Genomix chain compaction) on 2**22 k-mer vertices
    t = time.perf_counter()
    nc = 2 ** chain_scale
    chain = chain_graph(nc)
    pm = PathMerge(rounds=16)
    res_g, st = drive(pm, chain, nc, 2, device)
    need_launches("PathMerge", st, ("csr_spmv",), device)
    if path_merge_child is not None:
        cpu_vert, cpu_steps, cpu_s, waited = path_merge_child.result()
    else:
        res_c, _ = drive(pm, chain, nc, 2, "cpu")
        cpu_vert, cpu_steps, cpu_s, waited = (res_c.vertex, res_c.supersteps,
                                              None, None)
    if not same_relation(res_g.vertex, cpu_vert) or \
            res_g.supersteps != cpu_steps:
        raise AssertionError("PathMerge on the card differs from the CPU "
                             "path")
    vid = res_g.vertex.vid.reshape(-1).cpu().numpy()
    acc = res_g.vertex.value.reshape(-1, 2).cpu().numpy()[vid >= 0, 0]
    mass = float(acc.astype(np.float64).sum())
    if mass != nc:
        raise AssertionError(f"PathMerge lost mass: {mass} != {nc}")
    out["path_merge"] = dict(st, survivors=int((vid >= 0).sum()),
                             mass=mass, cpu_run_s=cpu_s,
                             cpu_wait_s=waited,
                             phase_s=time.perf_counter() - t)
    del res_g, cpu_vert, chain
    free(device)
    log(f"phase 10: PathMerge {json.dumps(out['path_merge'])}")

    # inserts at the default mutation_cap (64): the run regrows it
    prog = insert_program(n)
    res, st = drive(prog, edges, n, 1, device)
    regrows = [dict(superstep=e["superstep"], mutation_cap=e["mutation_cap"],
                    sources=e["sources"])
               for e in res.stats if e.get("event") == "regrow"]
    if not any(2 in e["sources"] for e in regrows):
        raise AssertionError("the insert program never regrew the "
                             "mutation capacity")
    got = gather_values(res.vertex, n)[:, 0]
    want = ((np.arange(n) - 3) % n + 1000).astype(np.float32)
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"inserts: {bad} vertices off the closed form")
    out["insert"] = dict(st, regrows=regrows)
    del res
    free(device)
    log(f"phase 10: inserts {json.dumps(out['insert'])}")

    # a custom combine at webmap-tiny's shape, card vs CPU
    nt = 20_000
    tiny = rmat_graph(nt, 240_000, seed=1)
    out["custom"] = {}
    for sc in (True, False):
        plan = PhysicalPlan(join="full_outer", groupby="sort",
                            sender_combine=sc)
        rg, st = drive(min_label_program(), tiny, nt, 2, device, plan=plan)
        rc, _ = drive(min_label_program(), tiny, nt, 2, "cpu", plan=plan)
        if not same_relation(rg.vertex, rc.vertex) or \
                rg.supersteps != rc.supersteps:
            raise AssertionError(f"custom combine (sender_combine={sc}): "
                                 "card differs from the CPU path")
        out["custom"][f"sender_combine={sc}"] = st
    log(f"phase 10: custom combine {json.dumps(out['custom'])}")
    return out


# ------------------------------------------------------------- phase 11

class CheckpointClock:
    """Times the checkpoint module's I/O inside the drivers' calls: each
    save (np.savez_compressed, then the CRC of the file), each load and
    each repartition, with the snapshot's bytes. Installed around a phase
    and restored after it."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        import repro_torch.runtime.checkpoint as ck
        self.ck = ck
        self.saved = (ck.np.savez_compressed, ck._file_crc,
                      ck.load_checkpoint, ck.repartition)
        savez, crc, load, repart = self.saved

        def timed(kind, fn, size_of=None):
            def f(*a, **kw):
                t = time.perf_counter()
                r = fn(*a, **kw)
                ev = {"what": kind, "s": time.perf_counter() - t}
                if size_of is not None:
                    ev["bytes"] = Path(size_of(a)).stat().st_size
                self.events.append(ev)
                return r
            return f
        ck.np.savez_compressed = timed("savez_compressed", savez,
                                       lambda a: a[0])
        ck._file_crc = timed("crc", crc)
        ck.load_checkpoint = timed("load", load, lambda a: a[0])
        ck.repartition = timed("repartition", repart)
        return self

    def __exit__(self, *exc):
        (self.ck.np.savez_compressed, self.ck._file_crc,
         self.ck.load_checkpoint, self.ck.repartition) = self.saved
        return False


def checkpoints_and_recovery(edges, n, values, pr_ref, hops, *,
                             device="cuda", scale=None) -> dict:
    """Phase 11 on a graph500 graph (``edges``, ``n``; ``values`` its
    uninterrupted PageRank and SSSP runs, ``pr_ref`` and ``hops`` their
    scipy references): SSSP under recover=True with a one-shot
    WorkerFailure(1) after superstep 5 (restore of the superstep-3
    snapshot onto 3 partitions, replay), and PageRank resumed from its
    superstep-10 snapshot. ``scale`` labels the printed line."""
    from repro_torch.core import gather_values, run_host
    from repro_torch.graph import SSSP, PageRank
    from repro_torch.graph.algorithms import INF
    from repro_torch.runtime.failure import WorkerFailure
    out = {}
    with tempfile.TemporaryDirectory() as d, CheckpointClock() as clock:
        fired = []

        def inject(i, v, m, g):
            if i == 5 and not fired:
                fired.append(i)
                raise WorkerFailure(1, "injected after superstep 5")

        sp = SSSP(source=0)
        res, st = drive(sp, edges, n, 1, device, checkpoint_every=3,
                        checkpoint_dir=d, recover=True,
                        failure_injector=inject)
        if len(res.recovery) != 1:
            raise AssertionError(f"recovery events: {res.recovery}")
        ev = res.recovery[0]
        if not (str(ev["restored_from"]).endswith("ckpt_000003.npz")
                and ev["healthy_workers"] == 3
                and res.vertex.num_partitions == 3):
            raise AssertionError(f"elastic restore went wrong: {ev}")
        dist = gather_values(res.vertex, n)[:, 0]
        want = np.where(np.isinf(hops), np.float32(INF), hops) \
            .astype(np.float32)
        bad = int((dist != want).sum())
        if bad or not np.array_equal(dist, values["sssp"][:, 0]):
            raise AssertionError(f"recovered SSSP differs from scipy at "
                                 f"{bad} vertices, or from the "
                                 "uninterrupted run")
        out["sssp_recovery"] = dict(
            st, recovery={k: ev[k] for k in ("restored_from",
                                             "healthy_workers",
                                             "blacklist")})
        del res
        free(device)

        # PageRank: snapshot at superstep 10, round trip, resume
        pr = PageRank(n, iterations=15)
        kept = {}

        def keep(i, v, m, g, rec):
            if i == 10:
                kept["state"] = (v, m, g)

        res, st = drive(pr, edges, n, 2, device, checkpoint_every=10,
                        checkpoint_dir=d, on_superstep=keep)
        full = gather_values(res.vertex, n)[:, 0]
        vert = res.vertex
        del res
        path = str(Path(d) / "ckpt_000010.npz")
        loaded = clock.ck.load_checkpoint(path, device=device)
        if not all(same_relation(a, b) for a, b in
                   zip(loaded, kept.pop("state"))):
            raise AssertionError("PageRank snapshot: save -> load is not "
                                 "bit-equal")
        del loaded
        t = time.perf_counter()
        res = run_host(vert, pr, pr.suggested_plan, max_supersteps=100,
                       resume_from=path)
        free(device)
        resume_s = time.perf_counter() - t
        ranks = gather_values(res.vertex, n)[:, 0]
        # two card runs need not agree bit for bit: scatter_add_ on CUDA
        # adds in an order that changes from run to run
        card_err = float(np.abs(ranks - full).max())
        if not np.allclose(ranks, full, rtol=1e-5, atol=0) or \
                not np.allclose(ranks.astype(np.float64), pr_ref,
                                rtol=1e-4, atol=0):
            raise AssertionError(f"resumed PageRank off: max abs err vs the "
                                 f"uninterrupted run {card_err}")
        if not np.allclose(full, values["pagerank"][:, 0], rtol=1e-5,
                           atol=0):
            raise AssertionError("PageRank with checkpoints differs from "
                                 "the uninterrupted run")
        out["pagerank_resume"] = dict(
            st, resumed_supersteps=res.supersteps - 10, resume_run_s=resume_s,
            max_abs_err_vs_uninterrupted=card_err)
        del res, vert
        free(device)
    out["checkpoint_io"] = clock.events
    log(f"phase 11 (graph500-{scale}): {json.dumps(out)}")
    return out


def graph_and_references(scale: int, device="cuda"):
    """A graph500-``scale`` graph with its uninterrupted PageRank and SSSP
    runs (suggested plans) held to scipy: -> (edges, n, values, scipy
    PageRank, scipy hop counts)."""
    from repro_torch.graph import graph500
    edges, n = graph500(scale)
    values = run_main_path(edges, n, device, {})
    pr_ref, hops = check_main_path(values, edges, n)
    return edges, n, values, pr_ref, hops


# ------------------------------------------------------------- phase 12

GRID_SIDE = 1024   # SSSP's road-network stand-in: 2**20 vertices
COPY_ELEMS = 2 ** 29   # float32: 2 GiB a copy


def machine_constants() -> dict:
    """The H100 machine model's bandwidths, measured: a device-to-device
    copy (bytes read + written over its CUDA-event time), pinned host ->
    device and device -> host copies (bytes over time) and a host numpy
    copy (read + written over host-clock time), 2 GiB each, beside the
    committed H100_MACHINE. disk_bw and net_latency_s are not measured
    (one card, no out-of-core run)."""
    import torch
    from repro_torch.planner import H100_MACHINE
    a = torch.empty(COPY_ELEMS, device="cuda")
    b = torch.empty_like(a)
    nbytes = a.numel() * a.element_size()
    d2d_ms = time_ms(lambda: b.copy_(a), reps=10)
    del b
    h = torch.empty(COPY_ELEMS, pin_memory=True)
    h2d_ms = time_ms(lambda: a.copy_(h, non_blocking=True), reps=5)
    d2h_ms = time_ms(lambda: h.copy_(a, non_blocking=True), reps=5)
    del a, h
    torch.cuda.empty_cache()
    x = np.ones(nbytes // 8, np.float64)
    y = np.empty_like(x)
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        np.copyto(y, x)
        walls.append(time.perf_counter() - t)
    del x, y
    return dict(
        copy_bytes=nbytes,
        hbm_bw=2 * nbytes / (d2d_ms / 1e3),
        host_bw_h2d=nbytes / (h2d_ms / 1e3),
        host_bw_d2h=nbytes / (d2h_ms / 1e3),
        host_mem_bw=2 * nbytes / statistics.median(walls),
        committed={k: getattr(H100_MACHINE, k) for k in (
            "peak_flops", "hbm_bw", "link_bw", "host_bw", "disk_bw",
            "host_mem_bw", "net_bw", "net_latency_s")})


# the fit's clamps (planner/cost.py _fit_constants)
CLAMPS = dict(k_compute=(0.5, 128.0), k_scatter=(1.0, 64.0),
              sort_pass_frac=(0.02, 4.0))


def calibrate(prog, g, machine) -> dict:
    """calibrate_machine at ``g``'s shapes, refit twice (not from the
    cache): the seconds of each (the first pays the process's first
    meta-tensor dispatches) and the fitted constants, inside their
    clamps."""
    from repro_torch.planner import calibrate_machine
    walls = []
    for _ in range(2):
        t = time.perf_counter()
        m = calibrate_machine(prog, g, machine, refresh=True)
        walls.append(time.perf_counter() - t)
    out = dict(seconds=walls[0], seconds_again=walls[1])
    for k, (lo, hi) in CLAMPS.items():
        v = getattr(m, k)
        if not lo <= v <= hi:
            raise AssertionError(f"calibrated {k} = {v} outside [{lo}, "
                                 f"{hi}]")
        out[k] = v
    return out


def fmt_plan(p) -> str:
    return (f"{p.join}/{p.groupby}/{p.connector}/"
            f"{'combine' if p.sender_combine else 'no-combine'}")


def planned_run(prog, edges, n, vd, device, plan="auto", max_supersteps=60,
                calibrate_to=None, auto_config=None):
    """One run through load_graph -> run_host(plan) on ``device``, the
    counts set to 0 just before run_host and read just after. The plans
    are the run's own: its initial plan (``RunResult.initial_plan``) and
    its ``plan-switch`` events. The kernels that those plans call for
    must have launched: the gather under a full-outer plan, the fold
    under a sender combine of a named monoid. ``calibrate_to`` (a dict)
    receives calibrate_machine's constants at this graph's statistics
    first; ``auto_config`` goes to run_host."""
    import torch
    from repro_torch.core import load_graph, run_host
    from repro_torch.kernels import COUNTERS
    from repro_torch.planner import GraphStats, machine_for
    vert = load_graph(edges, n, P, value_dims=vd, device=device)
    if calibrate_to is not None:
        calibrate_to.update(calibrate(prog, GraphStats.from_vertex(
            vert, prog), machine_for(device)))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    reset_counters()
    t0 = time.perf_counter()
    res = run_host(vert, prog, plan, max_supersteps=max_supersteps,
                   auto_config=auto_config)
    sync()
    run_s = time.perf_counter() - t0
    del vert
    walls = [st["wall_s"] for st in res.stats if "wall_s" in st]
    switches = [st for st in res.stats if st.get("event") == "plan-switch"]
    first = res.initial_plan
    plans = [first] + [dataclasses.replace(
        first, join=sw["join"], groupby=sw["groupby"],
        connector=sw["connector"], sender_combine=sw["sender_combine"])
        for sw in switches]
    st = dict(supersteps=res.supersteps, run_s=run_s,
              superstep_median_s=statistics.median(walls),
              initial_plan=fmt_plan(first),
              switches=[(sw["superstep"], fmt_plan(p))
                        for sw, p in zip(switches, plans[1:])],
              final_plan=fmt_plan(res.plan),
              events=[e["event"] for e in res.stats if "event" in e],
              launches={k: c.launches for k, c in COUNTERS.items()})
    need = []
    if any(p.join == "full_outer" for p in plans):
        need.append("csr_spmv")
    if prog.combine_op != "custom" and any(p.sender_combine for p in plans):
        need.append("segment_combine")
    need_launches(f"{type(prog).__name__} ({st['initial_plan']})", st, need,
                  device)
    return res, st


def planner_phase(edges, n, pr_ref, hops, static=None, *, device="cuda",
                  grid_side=GRID_SIDE) -> dict:
    """Phase 12, the cost-based planner on the graph path: the machine
    constants measured on the card (``device="cuda"``), calibrate_machine
    at the graph's statistics, PageRank (15 iterations) and SSSP from
    vertex 0 under plan="auto" held to scipy as phase 3's are, and SSSP
    from the corner of grid_graph(grid_side) under plan="auto" (at least
    one plan switch, ending left-outer), under SSSP.suggested_plan and
    under plan="auto" with the calibrated constants, all equal to row +
    col. ``static`` is phase 3's stats, printed beside the auto runs."""
    from repro_torch.core import gather_values
    from repro_torch.graph import SSSP, PageRank, grid_graph
    from repro_torch.graph.algorithms import INF
    from repro_torch.planner import AdaptiveConfig, machine_for
    out = {}
    if device == "cuda":
        out["machine"] = machine_constants()
        log(f"phase 12: machine constants {json.dumps(out['machine'])}")
    static = static or {}
    calib = {}
    pr = PageRank(n, iterations=15)
    calib["pagerank"] = {}
    res, st = planned_run(pr, edges, n, 2, device,
                          calibrate_to=calib["pagerank"])
    ranks = gather_values(res.vertex, n)[:, 0].astype(np.float64)
    rel = float((np.abs(ranks - pr_ref) / np.abs(pr_ref)).max())
    if not np.allclose(ranks, pr_ref, rtol=1e-4, atol=0):
        raise AssertionError(f"auto PageRank off scipy: max rel err {rel}")
    out["pagerank"] = dict(st, max_rel_err=rel, static_superstep_median_s=(
        static.get("pagerank", {}).get("superstep_median_s")))
    del res
    free(device)
    calib["sssp"] = {}
    res, st = planned_run(SSSP(source=0), edges, n, 1, device,
                          calibrate_to=calib["sssp"])
    want = np.where(np.isinf(hops), np.float32(INF), hops).astype(np.float32)
    bad = int((gather_values(res.vertex, n)[:, 0] != want).sum())
    if bad:
        raise AssertionError(f"auto SSSP differs from scipy at {bad} "
                             "vertices")
    out["sssp"] = dict(st, static_superstep_median_s=(
        static.get("sssp", {}).get("superstep_median_s")))
    del res
    free(device)
    m = machine_for(device)
    out["calibrated"] = dict(calib, machine_kernels=m.cuda_kernels,
                             defaults=dict(k_compute=m.k_compute,
                                           k_scatter=m.k_scatter,
                                           sort_pass_frac=m.sort_pass_frac))
    log(f"phase 12: calibrated {json.dumps(out['calibrated'])}")
    log(f"phase 12: auto PageRank {json.dumps(out['pagerank'])}")
    log(f"phase 12: auto SSSP {json.dumps(out['sssp'])}")

    # the switch at scale: SSSP from the corner of a side x side lattice
    ge = grid_graph(grid_side)
    gn = grid_side * grid_side
    v = np.arange(gn)
    closed = (v // grid_side + v % grid_side).astype(np.float32)
    for label, plan, cfg in (
            ("grid_auto", "auto", None),
            ("grid_static", SSSP.suggested_plan, None),
            # the constants that calibrate_machine fitted above (cached
            # per device type and combine op) choosing the plans
            ("grid_auto_calibrated", "auto",
             AdaptiveConfig(calibrate=True))):
        prog = SSSP(source=0)
        res, st = planned_run(prog, ge, gn, 1, device, plan,
                              max_supersteps=2 * grid_side + 8,
                              auto_config=cfg)
        dist = gather_values(res.vertex, gn)[:, 0]
        bad = int((dist != closed).sum())
        if bad:
            raise AssertionError(f"{label}: SSSP differs from row + col at "
                                 f"{bad} vertices")
        if plan == "auto" and not (st["switches"]
                                   and res.plan.join == "left_outer"):
            raise AssertionError(f"{label}: no switch to left-outer "
                                 f"({st['switches']}, {st['final_plan']})")
        out[label] = dict(st, vertices=gn, edges=len(ge))
        log(f"phase 12: {label} {json.dumps(out[label])}")
        del res
        free(device)
    return out


# ------------------------------------------------------------- phase 13

OOC_P = 8           # partitions of the out-of-core runs
OOC_BUDGET = 2      # partitions on the card at a time: 4 super-partitions


def ooc_block_bytes(vert, sp: int) -> int:
    """Bytes of one super-partition's vertex block (its six relation
    slices), the least a pipeline slot holds on the card."""
    per = sum(getattr(vert, f).element_size() * getattr(vert, f).numel()
              for f in ("vid", "halt", "value", "edge_src", "edge_dst",
                        "edge_val"))
    return per * sp // vert.num_partitions


def ooc_run(prog, vert, device, plan=None, **kw):
    """One run_out_of_core of ``prog`` over the CPU-resident ``vert``
    (OOC_BUDGET partitions a super-partition), with the counts set to 0
    just before it and read just after. -> (RunResult, stats dict):
    supersteps, run s, median superstep s, the median readiness stall,
    the dispatch / collect-wait / commit seconds summed over the run,
    the plans (initial, switches, final) and the launches."""
    import torch
    from repro_torch.core.ooc import run_out_of_core
    from repro_torch.kernels import COUNTERS
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    reset_counters()
    t0 = time.perf_counter()
    res = run_out_of_core(vert, prog, plan or prog.suggested_plan,
                          budget_partitions=OOC_BUDGET, device=device,
                          max_supersteps=kw.pop("max_supersteps", 100),
                          **kw)
    sync()
    run_s = time.perf_counter() - t0
    recs = [s for s in res.stats if "wall_s" in s]
    st = dict(supersteps=res.supersteps, run_s=run_s,
              superstep_median_s=statistics.median(
                  [s["wall_s"] for s in recs]),
              readiness_stall_median_s=statistics.median(
                  [s["readiness_stall_s"] for s in recs]),
              split_s={k: sum(s[k + "_s"] for s in recs)
                       for k in ("dispatch", "collect_wait", "commit")},
              initial_plan=fmt_plan(res.initial_plan),
              switches=[(s["superstep"], s["join"], s["connector"],
                         s["sender_combine"], s["storage"])
                        for s in res.stats
                        if s.get("event") == "plan-switch"],
              final_plan=fmt_plan(res.plan) + "/" + res.plan.storage,
              events=[s["event"] for s in res.stats if "event" in s],
              launches={k: c.launches for k, c in COUNTERS.items()})
    return res, st


def rel_close(got, want, rtol: float, what: str) -> float:
    """Max relative error of ``got`` against ``want``; raises past
    ``rtol``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    rel = float((np.abs(got - want) / np.abs(want)).max())
    if not np.allclose(got, want, rtol=rtol, atol=0):
        raise AssertionError(f"{what}: max rel err {rel} > {rtol}")
    return rel


def superstep_busy(prog, vert, device) -> dict:
    """Device time of one streamed superstep (the third, profiled from
    the on_superstep hook after the second to the hook after the third):
    kernel and copy time by torch.profiler, over the host wall time. The
    shares are sums over a stream each, so copies that overlap kernels
    count in both."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    box = {}

    def hook(i, rec):
        if i == 2:
            torch.cuda.synchronize()
            # device activity only: host-op recording would slow the
            # host-bound superstep it measures
            box["prof"] = profile(activities=[ProfilerActivity.CUDA])
            box["prof"].__enter__()
            box["t"] = time.perf_counter()
        elif i == 3:
            torch.cuda.synchronize()
            box["wall_ms"] = (time.perf_counter() - box["t"]) * 1e3
            box["prof"].__exit__(None, None, None)

    ooc_run(prog, vert, device, max_supersteps=3, on_superstep=hook)
    ev = [e for e in box["prof"].key_averages()
          if _device_ms(e) > 0 and e.device_type.name == "CUDA"]
    copies = sum(_device_ms(e) for e in ev if "Memcpy" in e.key)
    kernels = sum(_device_ms(e) for e in ev if "Memcpy" not in e.key)
    top = sorted(ev, key=_device_ms, reverse=True)[:6]
    return dict(wall_ms=box["wall_ms"], kernel_busy_ms=kernels,
                copy_busy_ms=copies,
                kernel_busy_share=kernels / box["wall_ms"],
                copy_busy_share=copies / box["wall_ms"],
                top=[(e.key[:50], round(_device_ms(e), 3)) for e in top])


def out_of_core_phase(big, small, *, device="cuda") -> dict:
    """Phase 13: run_out_of_core with the graph on the host and
    OOC_BUDGET of OOC_P partitions on the card at a time. ``big`` and
    ``small`` are graph_and_references tuples (edges, n, run_host values,
    scipy PageRank, scipy hops): phase 3's graph and phase 11's.
    On ``big``, pure-DRAM tier, streamed and barrier-free: PageRank (15
    iterations) within rtol 1e-4 of scipy and 1e-5 of run_host, both
    graph kernels launched; SSSP from vertex 0 equal to scipy, the fold
    launched; the peak of max_memory_allocated beside one
    super-partition's vertex block. On ``small``: PageRank synchronous
    beside streamed with a checkpoint at superstep 10, the disk tier
    (a budget of a third of the DRAM run's peak pager bytes, mru, one I/O
    thread) and the resume from the checkpoint, each within rtol 1e-5 of
    the streamed run (bit equality reported: the card's scatter-adds
    need not add in one order); SSSP under plan="auto" equal to scipy;
    and the device busy share of one streamed superstep."""
    import torch
    from repro_torch.core import gather_values, load_graph
    from repro_torch.graph import SSSP, PageRank
    from repro_torch.graph.algorithms import INF
    cuda = device == "cuda"
    out = {}

    def need(what, st, names):
        need_launches(what, st, names, device)

    def hops_equal(res, n, hops, what):
        want = np.where(np.isinf(hops), np.float32(INF), hops) \
            .astype(np.float32)
        bad = int((gather_values(res.vertex, n)[:, 0] != want).sum())
        if bad:
            raise AssertionError(f"{what}: differs from scipy at {bad} "
                                 "vertices")

    # -- the big graph: pure-DRAM tier, streamed, barrier-free
    edges, n, values, pr_ref, hops = big
    t = time.perf_counter()
    vert = load_graph(edges, n, OOC_P, value_dims=2, device="cpu")
    load_s = time.perf_counter() - t
    block = ooc_block_bytes(vert, OOC_BUDGET)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    res, st = ooc_run(PageRank(n, iterations=15), vert, device)
    ranks = gather_values(res.vertex, n)[:, 0]
    st["max_rel_err_scipy"] = rel_close(ranks, pr_ref, 1e-4,
                                        "ooc PageRank vs scipy")
    st["max_rel_err_run_host"] = rel_close(
        ranks, values["pagerank"][:, 0], 1e-5, "ooc PageRank vs run_host")
    if cuda:
        st["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        st["block_bytes"] = block
        st["peak_over_block"] = st["peak_allocated_bytes"] / block
    need("out-of-core PageRank", st, GRAPH_KERNELS)
    out["pagerank_big"] = dict(st, vertices=n, edges=len(edges),
                               partitions=OOC_P, load_s=load_s)
    log(f"phase 13: PageRank {json.dumps(out['pagerank_big'])}")
    del res
    vert = dataclasses.replace(vert, value=vert.value[..., :1].clone())
    res, st = ooc_run(SSSP(source=0), vert, device)
    hops_equal(res, n, hops, "ooc SSSP")
    need("out-of-core SSSP", st, ("segment_combine",))
    out["sssp_big"] = st
    log(f"phase 13: SSSP {json.dumps(st)}")
    del res, vert
    free(device)

    # -- the small graph: sync vs streamed, disk tier, checkpoint, auto
    edges, n, values, pr_ref, hops = small
    vert = load_graph(edges, n, OOC_P, value_dims=2, device="cpu")
    pr = PageRank(n, iterations=15)
    with tempfile.TemporaryDirectory() as d:
        ck = Path(d) / "ckpt"
        res, st = ooc_run(pr, vert, device, checkpoint_every=10,
                          checkpoint_dir=str(ck))
        streamed = gather_values(res.vertex, n)[:, 0]
        peak_pager = max(s["pager_peak_bytes"] for s in res.stats
                         if "pager_peak_bytes" in s)
        st["max_rel_err_run_host"] = rel_close(
            streamed, values["pagerank"][:, 0], 1e-5,
            "streamed PageRank vs run_host")
        need("out-of-core PageRank (small)", st, GRAPH_KERNELS)
        out["pagerank_streamed"] = dict(st, pager_peak_bytes=peak_pager)
        del res

        def against_streamed(label, res, st):
            got = gather_values(res.vertex, n)[:, 0]
            st["max_rel_err_streamed"] = rel_close(
                got, streamed, 1e-5, f"{label} vs the streamed run")
            st["bit_equal_streamed"] = bool(np.array_equal(got, streamed))
            out[label] = st

        res, st = ooc_run(pr, vert, device, stream=False)
        against_streamed("pagerank_sync", res, st)
        del res
        budget = peak_pager // 3
        res, st = ooc_run(pr, vert, device, memory_budget_bytes=budget,
                          disk_dir=str(Path(d) / "spill"), eviction="mru",
                          io_threads=1)
        recs = [s for s in res.stats if "wall_s" in s]
        st.update(budget_bytes=budget,
                  cache_hit_rate_median=statistics.median(
                      [s["cache_hit_rate"] for s in recs]),
                  spill_read_bytes=sum(s["spill_read_bytes"] for s in recs),
                  spill_write_bytes=sum(s["spill_write_bytes"]
                                        for s in recs))
        if not st["spill_write_bytes"]:
            raise AssertionError("the disk tier never spilled")
        against_streamed("pagerank_disk", res, st)
        del res
        res, st = ooc_run(pr, None, device,
                          resume_from=str(ck / "ooc_000010"))
        st["resumed_supersteps"] = res.supersteps - 10
        against_streamed("pagerank_resumed", res, st)
        del res
    res, st = ooc_run(SSSP(source=0), dataclasses.replace(
        vert, value=vert.value[..., :1].clone()), device, plan="auto")
    hops_equal(res, n, hops, "ooc auto SSSP")
    out["sssp_auto"] = st
    del res
    if cuda:
        out["busy"] = superstep_busy(pr, vert, device)
    del vert
    free(device)
    for label in ("pagerank_streamed", "pagerank_sync", "pagerank_disk",
                  "pagerank_resumed", "sssp_auto", "busy"):
        if label in out:
            log(f"phase 13: {label} {json.dumps(out[label])}")
    return out


# ------------------------------------------------------------- serving

def close_in_dtype(got, want, what: str) -> float:
    """Kernel vs plain in the working dtype. bfloat16 keeps 8 significant
    bits, so the two round a value to neighbouring bf16 numbers when their
    float32 sums (taken in another order) straddle a rounding boundary:
    allowed |got - want| <= 2**-6 |want| + 1e-3 (two units in the last
    place). float32: 2e-5 + 1e-5 |want| (sum order only)."""
    import torch
    g, w = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        tol = 2.0 ** -6 * w.abs() + 1e-3
    else:
        tol = 1e-5 * w.abs() + 2e-5
    bad = int(((g - w).abs() > tol).sum())
    err = max_abs_err(g, w)
    if bad or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: kernel != plain at {bad} elements "
                             f"(max abs err {err})")
    return err


def flash_parity() -> float:
    """flash_attention (kernel) vs attention_ref on the card, over the
    serving path's prefill shape and small edge cases."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    g = torch.Generator(device="cuda").manual_seed(7)
    rnd = lambda *s, dt: torch.randn(*s, generator=g, device="cuda") \
        .to(dt)
    err = 0.0
    # (BH, Sq, Sk, hd, causal, dtype): the main path's shape first
    sh = SERVE_SHAPE
    cases = [(sh["BH"], sh["S"], sh["S"], sh["hd"], True, torch.bfloat16)]
    for dt in (torch.float32, torch.bfloat16):
        for hd in (32, 64, 128):
            for causal in (True, False):
                cases += [(3, 64, 64, hd, causal, dt),
                          (2, 100, 100, hd, causal, dt),     # ragged
                          (2, 37, 300, hd, causal, dt),      # Sq < Sk
                          (1, 1, 129, hd, causal, dt),       # one query
                          # a second query block whose second warpgroup
                          # holds no row; ragged Sq < Sk over two blocks
                          (1, 130, 130, hd, causal, dt),
                          (2, 200, 260, hd, causal, dt)]
    for BH, Sq, Sk, hd, causal, dt in cases:
        q, k, v = rnd(BH, Sq, hd, dt=dt), rnd(BH, Sk, hd, dt=dt), \
            rnd(BH, Sk, hd, dt=dt)
        err = max(err, close_in_dtype(
            flash_attention(q, k, v, causal=causal),
            attention_ref(q, k, v, causal=causal),
            f"flash_attention BH={BH} Sq={Sq} Sk={Sk} hd={hd} "
            f"causal={causal} {dt}"))
    # GQA through ops, (B, S, H, hd) strided views of one projection
    for dt in (torch.float32, torch.bfloat16):
        for H, KV in ((16, 16), (8, 2), (4, 1)):
            B, S, hd = 2, 150, 128
            qkv = rnd(B, S, H + 2 * KV, hd, dt=dt)
            q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
            err = max(err, close_in_dtype(
                fa_ops.flash_attention(q, k, v, causal=True),
                fa_ops.attention_gqa_ref(q, k, v, causal=True),
                f"flash_attention GQA H={H} KV={KV} {dt}"))
    return err


def gmm_case(T: int, d: int, f: int, E: int, live: int, dt, seed: int,
             one_group=False):
    """Expert-sorted tokens, (E, d, f) weights, and group sizes spread
    over the first ``live`` experts (the rest empty, as the pad experts);
    ``one_group=True`` puts every row in one group, a list gives the
    sizes themselves."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(T, d, generator=g, device="cuda").to(dt)
    w = (torch.randn(E, d, f, generator=g, device="cuda") / d ** 0.5).to(dt)
    if isinstance(one_group, list):
        sizes = torch.tensor(one_group, device="cuda")
    elif one_group:
        sizes = torch.zeros(E, dtype=torch.int64, device="cuda")
        sizes[min(3, E - 1)] = T
    else:
        eid = torch.randint(0, live, (T,), generator=g, device="cuda")
        sizes = torch.bincount(eid, minlength=E)
    return x, w, sizes


def gmm_parity() -> float:
    from repro_torch.kernels.moe_gmm import (grouped_matmul,
                                             grouped_matmul_ref)
    import torch
    err = 0.0
    bf = torch.bfloat16
    sh = SERVE_SHAPE
    T_pre, T_dec, d, f, E, live = (sh[k] for k in ("T_pre", "T_dec", "d",
                                                  "f", "E", "live"))
    cases = [(T_pre, d, f, E, live, bf, False),       # prefill, w_gate/up
             (T_pre, f, d, E, live, bf, False),       # prefill, w_down
             (T_dec, d, f, E, live, bf, False),       # decode
             (T_dec, f, d, E, live, bf, False),
             (5000, 256, 136, 8, 5, bf, False),        # empty groups
             (4096, 128, 64, 6, 6, bf, True),          # one group
             (7, 64, 64, 4, 4, bf, False),             # T < one tile
             # a group of one row; a group ending mid-tile before a
             # non-empty one; T below one tile at d 1408; d 1408
             (300, 256, 384, 4, 4, bf, [1, 150, 0, 149]),
             (50, 1408, 256, 3, 3, bf, [20, 30, 0]),
             (1000, 1408, 2048, 8, 8, bf, False),
             # sizes summing below T (the tail to E - 1) and above it
             (200, 128, 128, 4, 4, bf, [50, 30, 20, 10]),
             (200, 128, 128, 4, 4, bf, [150, 100, 80, 40]),
             (300, 64, 128, 4, 4, torch.float32, False),
             (17, 16, 32, 3, 2, torch.float32, False),
             (1000, 128, 64, 16, 8, torch.float32, False),
             (500, 48, 40, 5, 5, torch.float32, True)]
    for i, (T, d, f, E, live, dt, one) in enumerate(cases):
        x, w, sizes = gmm_case(T, d, f, E, live, dt, 100 + i, one)
        want = grouped_matmul_ref(x, w, sizes)
        what = f"moe_gmm T={T} d={d} f={f} E={E} sizes={one} {dt}"
        err = max(err, close_in_dtype(grouped_matmul(x, w, sizes), want,
                                      what))
        if i == 4:                       # int32 sizes, as well as int64
            err = max(err, close_in_dtype(
                grouped_matmul(x, w, sizes.int()), want, what + " int32"))
    return err


def qwen_config(dispatch: str = "sort"):
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-moe-a2.7b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch))


def greedy(cfg, params, prompts, max_new: int):
    """Prefill + greedy decode through the port's step functions, on the
    device of ``params``. -> (ids (B, max_new), logits (B, max_new, V))."""
    import torch
    from repro_torch.models import make_decode_step, make_prefill_step
    S = prompts.shape[1]
    tok, caches, logits = make_prefill_step(cfg, max_len=S + max_new)(
        params, {"tokens": prompts})
    decode = make_decode_step(cfg)
    ids, out = [tok], [logits]
    for i in range(max_new - 1):
        tok, caches, logits = decode(params, tok, caches, S + i)
        ids.append(tok)
        out.append(logits)
    return torch.cat(ids, 1), torch.cat(out, 1)


def reduced_card_vs_cpu():
    """The reduced qwen2-moe (float32, sort dispatch) with the same
    weights on the card (kernels) and the CPU (plain versions): greedy
    ids equal, logits within atol 1e-4 (float32 through 4 layers summed
    in another order; logits of magnitude ~1)."""
    import copy
    import torch
    from repro_torch.models import init_params
    cfg = qwen_config().reduced()
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (3, 77), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(4))
    ids_c, log_c = greedy(cfg, params, prompts, 8)
    ids_g, log_g = greedy(cfg, copy.deepcopy(params).to("cuda"),
                          prompts.cuda(), 8)
    err = max_abs_err(log_g.cpu(), log_c)
    if not torch.equal(ids_g.cpu(), ids_c) or err > 1e-4:
        raise AssertionError(f"reduced model: card ids {ids_g.tolist()} vs "
                             f"CPU {ids_c.tolist()}, logits max abs err "
                             f"{err}")
    log(f"reduced qwen2-moe (f32, sort): card ids == CPU ids "
        f"{ids_c[0].tolist()}; logits max abs err {err:.3e}")


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def one_layer_check(params, cfg, prompts) -> dict:
    """Layer 0 of the full model on the prompts' hidden states: the
    attention sublayer and the MoE sublayer, each on one input, through
    the kernels and through the plain versions on the card (patched into
    the model's modules). Tolerance: relative L2 error <= 2**-7 (one unit
    in bf16's last place): the two differ only where bf16 rounds float32
    sums taken in another order."""
    from unittest import mock
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_gmm import grouped_matmul_ref
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.models.attention import apply_attention
    from repro_torch.models.layers import apply_norm, embed
    from repro_torch.models.moe import apply_moe
    from repro_torch.models.param import layer_slice
    p = layer_slice(params["stages"][0], 0)["sub0"]
    with torch.no_grad():
        x = embed(params["embed"], prompts)
        h = apply_norm(p["norm1"], x, cfg.norm)
        pos = torch.arange(x.shape[1], device=x.device)[None]
        attn = lambda: apply_attention(p["attn"], h, cfg, local=False,
                                       positions=pos)[0]
        a_k = attn()
        with mock.patch.object(fa_ops, "flash_attention",
                               fa_ops.attention_gqa_ref):
            a_p = attn()
        h2 = apply_norm(p["norm2"], x + a_k, cfg.norm)
        moe = lambda: apply_moe(p["moe"], h2, cfg)[0]
        m_k = moe()
        with mock.patch.object(gmm_ops, "grouped_matmul",
                               grouped_matmul_ref):
            m_p = moe()
    out = {"attention_rel_l2": rel_l2(a_k, a_p),
           "attention_max_abs_err": max_abs_err(a_k.float(), a_p.float()),
           "moe_rel_l2": rel_l2(m_k, m_p),
           "moe_max_abs_err": max_abs_err(m_k.float(), m_p.float())}
    for k in ("attention_rel_l2", "moe_rel_l2"):
        if not out[k] <= 2.0 ** -7:
            raise AssertionError(f"one layer, kernels vs plain: {out}")
    return out


def _forced_prefill(params, cfg, seq):
    """Last-position logits and S-slot caches of a prefill over ``seq``."""
    import torch
    from repro_torch.models import forward_prefill
    from repro_torch.models.layers import unembed
    with torch.no_grad():
        h, caches = forward_prefill(params, {"tokens": seq}, cfg)
        return unembed(params["embed"], h)[:, 0], caches


def teacher_forced_check(params, cfg, res) -> dict:
    """Decode against a prefill over the prompt plus the tokens generated
    before the last decode step (the same positions and weights, through
    the flash kernel and the prefill-sized grouped matmul).

    - K/V caches: the slots the decode steps wrote (prompt_len ..
      prompt_len + n - 1) against the prefill's K/V at those positions.
      Layer 0's K/V depend only on the token and its position, so they
      agree to bf16 rounding: relative L2 <= 2**-7 (a clamped or misplaced
      write gives ~1). Deeper layers carry the drift below; each <= 0.5.
    - Logits of the last decode step: relative L2 <= 0.5. Both paths run
      in bf16 through 24 layers of random weights and round at other
      places (decode rounds the softmax weights to bf16 before the PV
      product, as the JAX package does; the flash kernel keeps them at
      ~16 bits), and a top-4 expert choice on a near tie flips between
      the two, which moves that token's MoE output as a whole. Logits
      unrelated to each other give ~1.41. For scale, the same prefill
      through the plain versions instead of the kernels is printed
      beside it (``floor_rel_l2``)."""
    from unittest import mock
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_gmm import grouped_matmul_ref
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    S = res.prompts.shape[1]
    n = res.tokens.shape[1] - 1
    seq = torch.cat([res.prompts, torch.from_numpy(res.tokens[:, :n])
                     .to(res.prompts.device)], dim=1)
    forced, caches = _forced_prefill(params, cfg, seq)
    cache_err = []
    for st_dec, st_pre in zip(res.caches, caches):
        for sub, kv in st_pre.items():
            for name in ("k", "v"):
                want = kv[name][:, :, S:S + n]
                got = st_dec[sub][name][:, :, S:S + n]
                cache_err.append([rel_l2(g, w) for g, w in zip(got, want)])
    del caches
    layer_err = [max(e) for e in zip(*cache_err)]
    with mock.patch.object(fa_ops, "flash_attention",
                           fa_ops.attention_gqa_ref), \
            mock.patch.object(gmm_ops, "grouped_matmul",
                              grouped_matmul_ref):
        plain, caches = _forced_prefill(params, cfg, seq)
    del caches
    dec = res.logits[:, n]
    out = {"rel_l2": rel_l2(dec, forced),
           "max_abs_err": max_abs_err(dec.float(), forced.float()),
           "argmax_equal": int((dec.argmax(-1) == forced.argmax(-1)).sum()),
           "floor_rel_l2": rel_l2(plain, forced),
           "cache_rel_l2_layer0": layer_err[0],
           "cache_rel_l2_max": max(layer_err),
           "rows": dec.shape[0], "positions": seq.shape[1]}
    if not (out["cache_rel_l2_layer0"] <= 2.0 ** -7
            and out["cache_rel_l2_max"] <= 0.5 and out["rel_l2"] <= 0.5):
        raise AssertionError(f"decode vs teacher-forced prefill: {out}")
    return out


def full_width_f32_teacher_forced() -> dict:
    """qwen2-moe-a2.7b at full width cut to 2 layers, in float32 (TF32
    off), sort dispatch, on the card: every decode step's logits against a
    prefill over the prompt plus the tokens generated so far. Float32
    leaves only the sum order between the two paths, so: relative L2 <=
    1e-4 and the same greedy ids."""
    import torch
    from repro_torch.models import init_params
    cfg = dataclasses.replace(qwen_config(), num_layers=2, dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(11)
    params = init_params(cfg, g, "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (2, 300), generator=g,
                            device="cuda", dtype=torch.int32)
    new = 5
    ids, logits = greedy(cfg, params, prompts, new)
    worst = 0.0
    for i in range(1, new):
        seq = torch.cat([prompts, ids[:, :i]], dim=1)
        forced, caches = _forced_prefill(params, cfg, seq)
        del caches
        worst = max(worst, rel_l2(logits[:, i], forced))
        if not torch.equal(forced.argmax(-1).to(torch.int32), ids[:, i]):
            raise AssertionError(f"f32 full width: decode step {i}'s id "
                                 "differs from the teacher-forced prefill")
    if not worst <= 1e-4:
        raise AssertionError(f"f32 full width: decode vs teacher-forced "
                             f"prefill rel L2 {worst}")
    return {"layers": 2, "batch": 2, "prompt_len": 300, "steps": new - 1,
            "rel_l2_max": worst}


def serving_main_path(batch: int, prompt_len: int, max_new: int):
    """qwen2-moe-a2.7b (sort dispatch, bf16, random weights from a seeded
    generator on the card) through repro_torch.launch.serve.serve."""
    import torch
    from repro_torch.kernels import COUNTERS
    from repro_torch.launch.serve import serve
    cfg = qwen_config()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    res = serve(cfg, preset="full", batch=batch, prompt_len=prompt_len,
                max_new=max_new, seed=0, device="cuda")
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated()
    stats = dict(batch=batch, prompt_len=prompt_len, max_new=max_new,
                 prefill_ms=res.prefill_s * 1e3,
                 decode_ms_per_token=res.decode_s_per_token * 1e3,
                 prefill_tokens_per_s=batch * prompt_len / res.prefill_s,
                 decode_tokens_per_s=batch / res.decode_s_per_token,
                 max_memory_allocated_gb=peak / 1e9)
    return cfg, res, launches, stats


def warm_serving_timings(params, cfg, prompts, steps: int = 8) -> dict:
    """serve() times its first prefill and decode steps, which include the
    first calls' set-up (library handles, allocator growth). Here the same
    shapes again, warm: one prefill and the median of ``steps`` decode
    steps, host clock around a device sync."""
    import torch
    from repro_torch.models import make_decode_step, make_prefill_step
    B, S = prompts.shape
    prefill = make_prefill_step(cfg, max_len=S + steps)
    decode = make_decode_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, caches, _ = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    walls = []
    for i in range(steps):
        t0 = time.perf_counter()
        tok, caches, _ = decode(params, tok, caches, S + i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    dec_ms = statistics.median(walls)
    return dict(prefill_ms=prefill_ms, decode_ms_per_token=dec_ms,
                prefill_tokens_per_s=B * S / prefill_ms * 1e3,
                decode_tokens_per_s=B / dec_ms * 1e3,
                decode_ms_each=walls)


def profile_serving(params, cfg, prompts, out) -> dict:
    """Where the serving time goes: device time by kernel for one prefill
    of the serving batch and for one decode step after it."""
    from repro_torch.models import make_decode_step, make_prefill_step
    S = prompts.shape[1]
    prefill = make_prefill_step(cfg, max_len=S + 1)
    decode = make_decode_step(cfg)
    tok, caches, _ = prefill(params, {"tokens": prompts})
    res = {"prefill": profile_kernels(
        lambda: prefill(params, {"tokens": prompts}), 1, out,
        "serving prefill (batch x prompt)")}
    res["decode_step"] = profile_kernels(
        lambda: decode(params, tok, caches, S), 3, out,
        "serving decode step")
    return res


def check_serving_output(cfg, res):
    import torch
    if not bool(torch.isfinite(res.logits.float()).all()):
        raise AssertionError("serving: non-finite logits")
    ids = res.tokens
    if ids.shape != (res.prompts.shape[0], res.logits.shape[1]) or \
            not ((ids >= 0) & (ids < cfg.vocab_size)).all():
        raise AssertionError(f"serving: ids out of range {ids.shape}")
    if not np.array_equal(res.logits.argmax(-1).cpu().numpy(), ids):
        raise AssertionError("serving: ids are not the logits' argmax")


# H100 SXM, NVIDIA's data sheet: dense bf16 tensor-core rate
BF16_FLOP_PER_S = 989e12


def flash_timing(launches: int) -> dict:
    """flash_attention at the serving prefill's shape: B*H = 128, S =
    2048, hd = 128, bf16, causal."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    BH, S, hd = (SERVE_SHAPE[k] for k in ("BH", "S", "hd"))
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn(BH, S, hd, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    run_k = lambda: flash_attention(q, k, v, causal=True)
    run_p = lambda: attention_ref(q, k, v, causal=True)
    q4, k4, v4 = (t.view(1, BH, S, hd) for t in (q, k, v))
    run_l = lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=True)
    got, want = run_k(), run_p()
    err = close_in_dtype(got, want, "flash_attention timing inputs")
    ms, plain_ms, lib_ms = time_ms(run_k), time_ms(run_p, reps=5), \
        time_ms(run_l)
    # visible (query, key) pairs S(S+1)/2 a head, 2 hd FLOP each for QK^T
    # and for PV; q, k, v read and out written once
    flop = 2 * 2 * hd * (S * (S + 1) // 2) * BH
    nbytes = 4 * BH * S * hd * 2
    bound_ms = max(flop / BF16_FLOP_PER_S, nbytes / MEM_BYTES_PER_S) * 1e3
    return dict(name="flash_attention", route="cuda", source=FLASH_SRC,
                replaces=FLASH_REPLACES, launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="operations" if flop / BF16_FLOP_PER_S >
                nbytes / MEM_BYTES_PER_S else "bytes",
                library_ms=lib_ms,
                library="F.scaled_dot_product_attention(is_causal=True)",
                shape=dict(BH=BH, S=S, hd=hd, dtype="bfloat16"),
                flop=flop, bytes=nbytes)


def grouped_mm_library(x, w, sizes):
    """torch._grouped_mm on the same function, where this torch has it
    (a yardstick only; the port never calls it) -> callable or None."""
    import torch
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm absent"
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    call = lambda: fn(x, w, offs=offs)
    try:
        call()
        torch.cuda.synchronize()
    except Exception as e:  # a yardstick that does not run is reported
        return None, f"torch._grouped_mm failed: {type(e).__name__}: {e}"
    return call, "torch._grouped_mm"


def gmm_timing_one(T: int, d: int, f: int, touched_from_routing: bool,
                   seed: int) -> dict:
    import torch
    from repro_torch.kernels.moe_gmm import (grouped_matmul,
                                             grouped_matmul_cuda,
                                             grouped_matmul_ref)
    E, live = SERVE_SHAPE["E"], SERVE_SHAPE["live"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(T, d, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(E, d, f, generator=g, device="cuda") / d ** 0.5) \
        .to(torch.bfloat16)
    if touched_from_routing:
        # decode: T / 4 tokens, each to 4 distinct of the live experts
        eid = torch.stack([torch.randperm(live, generator=g,
                                          device="cuda")[:4]
                           for _ in range(T // 4)]).reshape(-1)
    else:
        eid = torch.randint(0, live, (T,), generator=g, device="cuda")
    eid = torch.sort(eid).values
    sizes = torch.bincount(eid, minlength=E)
    # the kernel's wrapper alone, and the entry point the model calls
    # (the same one launch, behind the device dispatch) as wrapper_ms
    run_k = lambda: grouped_matmul_cuda(x, w, sizes)
    run_w = lambda: grouped_matmul(x, w, sizes)
    run_p = lambda: grouped_matmul_ref(x, w, sizes)
    err = close_in_dtype(run_k(), run_p(),
                         f"moe_gmm timing inputs T={T} d={d} f={f}")
    lib, lib_name = grouped_mm_library(x, w, sizes)
    ms, plain_ms = time_ms(run_k), time_ms(run_p, reps=5)
    wrapper_ms = time_ms(run_w)
    lib_ms = time_ms(lib) if lib is not None else None
    # the host's time to enqueue one entry-point call (argument checks,
    # two tensor maps encoded, the launch), over calls not waited for
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        run_w()
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    touched = int((sizes > 0).sum())
    flop = 2 * T * d * f
    # tokens read, out written, and the weights of every expert touched
    nbytes = T * d * 2 + T * f * 2 + touched * d * f * 2
    t_op, t_b = flop / BF16_FLOP_PER_S, nbytes / MEM_BYTES_PER_S
    return dict(ms=ms, wrapper_ms=wrapper_ms, host_us=host_us,
                plain_ms=plain_ms,
                bound_ms=max(t_op, t_b) * 1e3,
                bound_by="operations" if t_op > t_b else "bytes",
                library_ms=lib_ms, library=lib_name, max_abs_err=err,
                shape=dict(T=T, d=d, f=f, E=E, experts_touched=touched),
                flop=flop, bytes=nbytes)


def tensor_map_encode_us(E: int, d: int, f: int) -> float:
    """Host µs of one cuTensorMapEncodeTiled call, as the grouped matmul
    makes for its (E, d, f) weight map on every call (two maps a call)."""
    import ctypes
    import torch
    w = torch.empty((E, d, f), dtype=torch.bfloat16, device="cuda")
    fn = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
    fn.restype = ctypes.c_int
    buf = ctypes.create_string_buffer(128 + 64)     # the map, 64-B aligned
    addr = ctypes.addressof(buf) + (-ctypes.addressof(buf)) % 64
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    dims = (u64 * 3)(f, d, E)
    strides = (u64 * 2)(f * 2, f * d * 2)
    box, ones = (u32 * 3)(64, 64, 1), (u32 * 3)(1, 1, 1)
    # bfloat16 = 9, no interleave, 128-byte swizzle = 3, L2 256 B = 3
    args = (ctypes.c_void_p(addr), 9, 3, ctypes.c_void_p(w.data_ptr()), dims,
            strides, box, ones, 0, 3, 3, 0)
    if fn(*args) != 0:
        raise AssertionError("cuTensorMapEncodeTiled refused the weight map")
    t0 = time.perf_counter()
    for _ in range(1000):
        fn(*args)
    return (time.perf_counter() - t0) * 1e3


def gmm_timing(launches: int) -> dict:
    """moe_gmm at the serving path's shapes: prefill (T = 8 * 2048 * 4
    routed rows) as w_gate / w_up (d -> f) and as w_down (f -> d), and
    decode (T = 8 * 4)."""
    T_pre, T_dec, d, f = (SERVE_SHAPE[k] for k in ("T_pre", "T_dec", "d",
                                                  "f"))
    pre = gmm_timing_one(T_pre, d, f, False, 9)
    down = gmm_timing_one(T_pre, f, d, False, 12)
    dec = gmm_timing_one(T_dec, d, f, True, 10)
    dec["tensor_map_encode_us"] = tensor_map_encode_us(SERVE_SHAPE["E"], d, f)
    return dict(name="moe_gmm", route="cuda", source=GMM_SRC,
                replaces=GMM_REPLACES, launches=launches, **pre,
                w_down=down, decode=dec)


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_counts() -> dict:
    """Per kernel library, how many HGMMA (wgmma), UTMALDG (TMA load) and
    HMMA (mma.sync) instructions its SASS holds (cuobjdump)."""
    import os
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = {}
    for name in build.KERNELS:
        sass = subprocess.run([tool, "--dump-sass",
                               str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        out[name] = {op: len(re.findall(rf"\s{op}[.\s]", sass))
                     for op in SASS_OPS}
    for name in SERVING_KERNELS:
        if not (out[name]["HGMMA"] and out[name]["UTMALDG"]):
            raise AssertionError(f"{name}: no wgmma or TMA load in its SASS "
                                 f"{out[name]}")
    return out


def ptxas_usage(name: str) -> dict:
    """Registers and spill bytes of each bf16 kernel in library ``name``,
    from ptxas's report in its build log."""
    from repro_torch.kernels import build
    out, fn = {}, None
    for ln in build.library_path(name).with_suffix(".log").read_text() \
            .splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            k = re.search(r"([a-z_]+_bf16)(?:ILi(\d+)E)?", m.group(1))
            fn = f"{k.group(1)}<{k.group(2)}>" if k and k.group(2) else \
                (k.group(1) if k else None)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if fn and m:
            out.setdefault(fn, {})["spill_bytes"] = int(m.group(1)) + \
                int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if fn and m:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
            fn = None
    return out


def check_launches(path: str, launches: dict, names):
    for k in names:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the {path} "
                                 "path")


def main(argv=None) -> int:
    global T0
    T0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="graph500 scale: 2**scale vertices, 16x edges")
    ap.add_argument("--profile-out", type=Path, default=None,
                    help="write the full profiler tables to this file")
    ap.add_argument("--path-merge-cpu", nargs=2, default=None,
                    help=argparse.SUPPRESS)   # phase 10's child process
    args = ap.parse_args(argv)
    if args.path_merge_cpu:
        path_merge_cpu(args.path_merge_cpu[0], int(args.path_merge_cpu[1]))
        return 0
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's smoke run needs one")
        return 2
    from repro_torch.kernels import build

    # 1. device + build
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"kernel build: {build.build_all():.2f} s")
    for lib, counts in sass_counts().items():
        log(f"sass {lib}: " + " ".join(f"{k} {v}" for k, v in
                                       counts.items()))
    for lib in SERVING_KERNELS:
        log(f"ptxas {lib}: {json.dumps(ptxas_usage(lib))}")
    # phase 10's CPU PathMerge runs beside the card phases from here on
    with tempfile.TemporaryDirectory() as tmp:
        child = PathMergeChild(tmp)
        try:
            return card_phases(args, name, child)
        finally:
            child.stop()


def card_phases(args, name: str, child) -> int:
    """Phases 2-13 on the card; ``child`` is phase 10's CPU PathMerge."""
    import torch
    from repro_torch.core import load_graph
    from repro_torch.graph import graph500
    from repro_torch.kernels import COUNTERS

    # 2. kernel parity on the card
    t = time.perf_counter()
    fold_err = fold_parity("cuda")
    torch.cuda.synchronize()
    gather_err = gather_parity("cuda")
    torch.cuda.synchronize()
    flash_err = flash_parity()
    torch.cuda.synchronize()
    gmm_err = gmm_parity()
    torch.cuda.synchronize()
    log(f"kernel parity: fold bit-exact (max abs err {fold_err}), gather "
        f"exact (max abs err {gather_err}), flash_attention (max abs err "
        f"{flash_err}), moe_gmm (max abs err {gmm_err}) in "
        f"{time.perf_counter() - t:.1f} s")

    # 3. main path at graph500-<scale>
    t = time.perf_counter()
    edges, n = graph500(args.scale)
    prep_s = time.perf_counter() - t
    log(f"data: graph500-{args.scale} shape, {n} vertices, {len(edges)} "
        f"edges, generated in {prep_s:.1f} s")
    stats = {}
    reset_counters()
    values = run_main_path(edges, n, "cuda", stats)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in COUNTERS.items()}
    log(f"main path: {json.dumps(stats)}")
    log(f"graph path launches: {json.dumps(launches)}")
    check_launches("graph", launches, GRAPH_KERNELS)
    pr_ref, hops = check_main_path(values, edges, n)

    # 4. CC / PageRank card vs CPU at webmap-tiny's shape
    card_vs_cpu()
    torch.cuda.synchronize()

    # 5. timings at the main path's shapes
    vert = load_graph(edges, n, P, value_dims=2, device="cuda")
    kernels = [fold_timing(vert, launches["segment_combine"]),
               gather_timing(vert, launches["csr_spmv"])]
    torch.cuda.synchronize()

    # 6. where the time goes (device time by kernel, busy share)
    log(f"profile: {json.dumps(profile_phase(vert, n, args.profile_out))}")
    torch.cuda.synchronize()
    log(f"superstep median wall s: pagerank "
        f"{stats['pagerank']['superstep_median_s']}, sssp "
        f"{stats['sssp']['superstep_median_s']}; data preparation s "
        f"{prep_s}")
    del vert
    torch.cuda.empty_cache()

    # 7. reduced qwen2-moe, card vs CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    reduced_card_vs_cpu()
    log(f"reduced model phase: {time.perf_counter() - t:.1f} s")

    # 8. serving path: qwen2-moe-a2.7b at full width
    t = time.perf_counter()
    cfg, res, s_launches, s_stats = serving_main_path(8, 2048, 32)
    log(f"serving path: {json.dumps(s_stats)}")
    log(f"serving path launches: {json.dumps(s_launches)}")
    check_launches("serving", s_launches, SERVING_KERNELS)
    check_serving_output(cfg, res)
    log(f"one layer, kernels vs plain on the card: "
        f"{json.dumps(one_layer_check(res.params, cfg, res.prompts))}")
    log(f"decode vs teacher-forced prefill: "
        f"{json.dumps(teacher_forced_check(res.params, cfg, res))}")
    res.caches = None
    log(f"serving, warm: "
        f"{json.dumps(warm_serving_timings(res.params, cfg, res.prompts))}")
    prof = profile_serving(res.params, cfg, res.prompts, args.profile_out)
    log(f"serving profile: {json.dumps(prof)}")
    del res
    torch.cuda.empty_cache()
    log(f"full width, 2 layers, float32, decode vs teacher-forced prefill: "
        f"{json.dumps(full_width_f32_teacher_forced())}")
    torch.cuda.empty_cache()
    log(f"serving phase: {time.perf_counter() - t:.1f} s")

    # 9. serving kernels' timings at the main path's shapes
    kernels += [flash_timing(s_launches["flash_attention"]),
                gmm_timing(s_launches["moe_gmm"])]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 10. mutations and the library programs at the graph path's shape
    t = time.perf_counter()
    phase10 = mutations_and_programs(edges, n, hops, child)
    log(f"phase 10: {time.perf_counter() - t:.1f} s; launches by path: "
        + json.dumps({k: v["launches"] for k, v in phase10.items()
                      if "launches" in v}))

    # 11. checkpoints and recovery, at graph500-20 (the snapshots' zlib
    # time at -22 took a quarter of the script)
    t = time.perf_counter()
    ck_scale = min(args.scale, CKPT_SCALE)
    small = graph_and_references(ck_scale)
    checkpoints_and_recovery(*small, scale=ck_scale)
    log(f"phase 11: {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()

    # 12. the cost-based planner: plan="auto" at graph500-<scale> and on
    # the lattice
    t = time.perf_counter()
    phase12 = planner_phase(edges, n, pr_ref, hops, stats)
    by_path = {k: v["launches"] for k, v in phase12.items()
               if "launches" in v}
    log(f"phase 12: {time.perf_counter() - t:.1f} s; launches by path: "
        + json.dumps(by_path))

    # 13. out-of-core: the graph on the host, a quarter of it on the card
    t = time.perf_counter()
    phase13 = out_of_core_phase((edges, n, values, pr_ref, hops), small)
    ooc_paths = {f"ooc_{k}": v["launches"] for k, v in phase13.items()
                 if "launches" in v}
    log(f"phase 13: {time.perf_counter() - t:.1f} s; launches by path: "
        + json.dumps(ooc_paths))
    by_path.update(ooc_paths)
    for k in kernels:
        if k["name"] in GRAPH_KERNELS:
            k["launches_by_path"] = {p: counts[k["name"]]
                                     for p, counts in by_path.items()}
    del edges, values, small
    log(f"chip_smoke: {time.perf_counter() - T0:.1f} s in all")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
