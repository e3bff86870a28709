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
   whose partitions differ in kind) must match segment_combine_blocked
   bit for bit, one partition at a time. The gather (V = 1, 2, 3 and 5,
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

Before its last line it prints the card's nvidia-smi line and one JSON
line with every kernel's name, route, source, the TPU kernel it
replaces, its launches on its main path, max abs err, kernel / plain /
bound / library ms. The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_host(vert, prog, prog.suggested_plan, max_supersteps=60)
        torch.cuda.synchronize()
        walls = [s["wall_s"] for s in res.stats if "wall_s" in s]
        stats_out[name] = dict(
            supersteps=res.supersteps, run_s=time.perf_counter() - t0,
            superstep_median_s=statistics.median(walls),
            superstep_median_after_first_s=(statistics.median(walls[1:])
                                            if len(walls) > 1 else None),
            events=[s["event"] for s in res.stats if "event" in s])
        out[name] = gather_values(res.vertex, n)
        del vert, res
        torch.cuda.empty_cache()
    return out


def check_main_path(values, edges, n):
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
    for c in COUNTERS.values():
        c.reset()
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="graph500 scale: 2**scale vertices, 16x edges")
    ap.add_argument("--profile-out", type=Path, default=None,
                    help="write the full profiler tables to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's smoke run needs one")
        return 2
    from repro_torch.core import load_graph
    from repro_torch.graph import graph500
    from repro_torch.kernels import COUNTERS, build

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
    for c in COUNTERS.values():
        c.reset()
    values = run_main_path(edges, n, "cuda", stats)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in COUNTERS.items()}
    log(f"main path: {json.dumps(stats)}")
    log(f"graph path launches: {json.dumps(launches)}")
    check_launches("graph", launches, GRAPH_KERNELS)
    check_main_path(values, edges, n)
    del values

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
    del vert, edges
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
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
