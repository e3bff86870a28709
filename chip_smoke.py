#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 22] [--profile-out PATH]

Phases, each of which raises on failure (so the script exits non-zero
and never prints its last line):

1. device: the card's name and power limit; the kernels' build time.
2. kernel parity: each CUDA kernel against its plain torch version on the
   same CUDA tensors — sum/min/max, D = 1 and 2, ragged tiles, all-invalid
   streams, NaN/+-inf payloads, int32-max keys, and the main path's
   shapes. The fold must match bit for bit (NaN positions matched); the
   gather exactly, NaN positions matched.
3. main path at the shape of LDBC Graphalytics' graph500-<scale> (Graph500
   R-MAT, edge factor 16, P = 4 partitions on one card): PageRank
   (full_outer, 15 iterations) and SSSP from vertex 0 (left_outer) through
   load_graph -> run_host -> gather_values, held to a scipy float64
   power iteration (rtol 1e-4) and to scipy's unweighted shortest paths
   (exact). Both kernels' launch counts over this phase must be > 0.
4. CC and PageRank at webmap-tiny's shape (rmat 20k/240k) on the card and
   through the port's plain path on the CPU: CC equal, PageRank within
   rtol 1e-5.
5. timings at the main path's shapes: kernel, plain and library-call ms
   (CUDA events, median of 20 after warm-up) beside the bound ms.
6. profile: device time by kernel (torch.profiler) for the fold's three
   launches and for one PageRank and one SSSP superstep, with the device
   busy share of the wall time; ``--profile-out PATH`` also writes the
   full profiler tables to PATH.

The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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
P = 4


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

def nan_matched_equal(a, b) -> bool:
    """Equal values, NaN where the other has NaN (torch.equal otherwise)."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    return torch.equal(torch.where(na, 0.0, a), torch.where(nb, 0.0, b))


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


def check_fold(keys, pay, valid, op):
    from repro_torch.kernels.segment_combine import (segment_combine,
                                                     segment_combine_blocked)
    M = pay.shape[0]
    got, last_k = segment_combine(keys, pay, valid, op, block_m=512)
    want, last_p = segment_combine_blocked(keys, pay, valid, op,
                                           block_m=512)
    if not (nan_matched_equal(got, want) and
            bool((last_k == last_p).all())):
        raise AssertionError(
            f"segment_combine {op} M={M} D={pay.shape[1]}: kernel != plain "
            f"(max abs err {max_abs_err(got, want)})")
    return max_abs_err(got, want)


def fold_parity(device) -> float:
    rng = np.random.default_rng(0)
    err = 0.0
    for op in ("sum", "min", "max"):
        for D in (1, 2):
            for M in (1, 300, 512, 1500, 100_003):
                for kind in ("plain", "all_invalid", "nonfinite",
                             "int32max"):
                    err = max(err, check_fold(*fold_case(rng, M, D, kind,
                                                         device), op))
    return err


def gather_case(rng, N: int, V: int, E: int, device):
    import torch
    from repro_torch.kernels.csr_spmv import plan_layout_fixed
    values = rng.normal(size=(N, V)).astype(np.float32)
    pick = rng.random((N, V))
    values[pick < 0.02] = np.inf
    values[(pick >= 0.02) & (pick < 0.04)] = -np.inf
    values[(pick >= 0.04) & (pick < 0.06)] = np.nan
    src = rng.integers(0, N, E).astype(np.int32)
    src[rng.random(E) < 0.1] = -1
    ev = rng.normal(size=E).astype(np.float32)
    perm, tile_row = plan_layout_fixed(src, N)
    t = lambda a: torch.from_numpy(a).to(device)
    return t(values), t(src), t(ev), (t(perm), t(tile_row))


def check_gather(values, src, ev, layout):
    from repro_torch.kernels.csr_spmv import edge_gather, edge_gather_ref
    got = edge_gather(values, src, ev, layout)
    want = edge_gather_ref(values, src, ev)
    if not nan_matched_equal(got, want):
        raise AssertionError(
            f"csr_spmv N={values.shape[0]} E={src.shape[0]}: kernel != "
            f"plain (max abs err {max_abs_err(got, want)})")
    return max_abs_err(got, want)


def gather_parity(device) -> float:
    rng = np.random.default_rng(1)
    err = 0.0
    for N, V, E in ((1, 1, 5), (300, 1, 1000), (1000, 2, 20_000),
                    (100_001, 2, 1_000_003)):
        values, src, ev, layout = gather_case(rng, N, V, E, device)
        err = max(err, check_gather(values, src, ev, layout))
        err = max(err, check_gather(values, src, None, layout))
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

def fold_timing(vert, launches: int) -> dict:
    """The sender fold at the main path's shape: partition 0's edge
    stream, keys = its dst vids stably sorted, padded to 512 rows."""
    import torch
    from repro_torch.kernels.backend import COMBINE_BLOCK_M
    from repro_torch.kernels.segment_combine import (segment_combine,
                                                     segment_combine_blocked)
    dst, ok = vert.edge_dst[0], vert.edge_src[0] >= 0
    key = torch.where(ok, dst, 2 ** 31 - 1)
    key = torch.sort(key, stable=True).values
    M0 = key.shape[0]
    pad = (-M0) % COMBINE_BLOCK_M
    key = torch.cat([key, torch.full((pad,), 2 ** 31 - 1, dtype=key.dtype,
                                     device=key.device)])
    M = key.shape[0]
    valid = key != 2 ** 31 - 1
    g = torch.Generator(device=key.device).manual_seed(5)
    pay = torch.rand((M, 1), generator=g, device=key.device)
    run_k = lambda: segment_combine(key, pay, valid, "sum", block_m=512)
    run_p = lambda: segment_combine_blocked(key, pay, valid, "sum",
                                            block_m=512)
    got, want = run_k()[0], run_p()[0]
    if not nan_matched_equal(got, want):
        raise AssertionError("segment_combine at the main-path shape: "
                             "kernel != plain")
    _, inv = torch.unique_consecutive(key, return_inverse=True)
    n_seg = int(inv.max()) + 1
    run_l = lambda: torch.zeros((n_seg, 1), device=key.device) \
        .scatter_reduce_(0, inv[:, None], pay, "sum", include_self=False)
    ms = time_ms(run_k)
    plain_ms = time_ms(run_p, reps=5, warmup=1)
    lib_ms = time_ms(run_l)
    # keys, payload and valid read; folded payload and is_last written
    nbytes = M * (4 + 4 + 1) + M * (4 + 1)
    return dict(name="segment_combine", route="cuda", source=FOLD_SRC,
                replaces=FOLD_REPLACES, launches=launches,
                max_abs_err=max_abs_err(got, want), ms=ms,
                plain_ms=plain_ms, bound_ms=nbytes / MEM_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=lib_ms, shape=dict(M=M, D=1))


def gather_timing(vert, launches: int) -> dict:
    """The edge gather at the main path's shape: all P partitions'
    edges in one stream over PageRank's (P * Np, 2) values."""
    import torch
    from repro_torch.core.driver import plan_gather_layout
    from repro_torch.core.plan import PhysicalPlan
    from repro_torch.kernels.csr_spmv import edge_gather, edge_gather_ref
    Pn, Np = vert.vid.shape
    perm, tile_row = plan_gather_layout(PhysicalPlan(), vert)
    off = (torch.arange(Pn, dtype=torch.int32, device=perm.device)
           * Np)[:, None]
    src = torch.where(vert.edge_src >= 0, vert.edge_src + off, -1) \
        .reshape(-1)
    g = torch.Generator(device=perm.device).manual_seed(6)
    values = torch.rand((Pn * Np, 2), generator=g, device=perm.device)
    values[::97, 0] = float("inf")
    values[::89, 1] = float("nan")
    run_k = lambda: edge_gather(values, src, None, (perm, tile_row))
    run_p = lambda: edge_gather_ref(values, src, None)
    got, want = run_k(), run_p()
    if not nan_matched_equal(got, want):
        raise AssertionError("csr_spmv at the main-path shape: kernel != "
                             "plain")
    ok = (src >= 0)[:, None]
    idx = src.clamp(min=0).long()
    run_l = lambda: torch.where(ok, values.index_select(0, idx), 0.0)
    ms = time_ms(run_k)
    plain_ms = time_ms(run_p)
    lib_ms = time_ms(run_l)
    E, V = src.shape[0], values.shape[1]
    # the function's bytes: src and values read, the output written; the
    # layout's perm is this design's overhead, reported beside the bound
    nbytes = E * 4 + values.numel() * 4 + E * V * 4
    layout_bytes = perm.numel() * 4 + tile_row.numel() * 4
    return dict(name="csr_spmv", route="cuda", source=GATHER_SRC,
                replaces=GATHER_REPLACES, launches=launches,
                max_abs_err=max_abs_err(got, want), ms=ms,
                plain_ms=plain_ms, bound_ms=nbytes / MEM_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=lib_ms,
                layout_ms_at_bound=layout_bytes / MEM_BYTES_PER_S * 1e3,
                shape=dict(E=E, slots=perm.numel(), rows=values.shape[0],
                           V=V))


def _device_ms(evt) -> float:
    t = getattr(evt, "device_time_total", None)
    if t is None:
        t = evt.cuda_time_total
    return t / 1e3


def profile_kernels(fn, reps: int, out_path, title: str) -> dict:
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler
    with CUDA activity), per call, plus the device busy share of the
    host wall time. The full table is appended to ``out_path`` if set."""
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
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "a") as f:
            f.write(f"== {title}: wall {wall_ms:.3f} ms/call, device busy "
                    f"{busy_ms:.3f} ms/call\n")
            f.write(prof.key_averages().table(row_limit=60))
            f.write("\n")
    top = [(e.key[:60], round(_device_ms(e) / reps, 4)) for e in kern[:8]]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms if wall_ms else None, top=top)


def profile_phase(vert, n, out) -> dict:
    """Where the time goes: the fold's three launches at the main path's
    shape, and one PageRank / SSSP superstep at graph500 scale."""
    import torch
    from repro_torch.core.driver import prepare_run
    from repro_torch.core.superstep import make_superstep
    from repro_torch.graph import SSSP, PageRank
    from repro_torch.kernels.backend import COMBINE_BLOCK_M
    from repro_torch.kernels.segment_combine import segment_combine
    if out is not None and out.exists():
        out.unlink()
    key = torch.sort(torch.where(vert.edge_src[0] >= 0, vert.edge_dst[0],
                                 2 ** 31 - 1), stable=True).values
    pad = (-key.shape[0]) % COMBINE_BLOCK_M
    key = torch.cat([key, torch.full((pad,), 2 ** 31 - 1, dtype=key.dtype,
                                     device=key.device)])
    valid = key != 2 ** 31 - 1
    pay = torch.ones((key.shape[0], 1), device=key.device)
    res = {"fold": profile_kernels(
        lambda: segment_combine(key, pay, valid, "sum", block_m=512), 5,
        out, "segment_combine at the main-path shape")}
    del key, pay, valid
    for name, prog in (("pagerank_superstep", PageRank(n, iterations=15)),
                       ("sssp_superstep", SSSP(source=0))):
        v = dataclasses.replace(vert, value=vert.value[..., :prog.value_dims]
                                .contiguous())
        ec, layout, v, m, g = prepare_run(v, prog, prog.suggested_plan, None)
        step = make_superstep(prog, prog.suggested_plan, ec)
        state = step(v, m, g, layout)      # superstep 0: every vertex sends
        res[name] = profile_kernels(lambda: step(*state, layout), 3, out,
                                    f"{name} (superstep 1, repeated)")
        del state, v, m, g, layout
        torch.cuda.empty_cache()
    return res


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

    # 2. kernel parity on the card
    t = time.perf_counter()
    fold_err = fold_parity("cuda")
    torch.cuda.synchronize()
    gather_err = gather_parity("cuda")
    torch.cuda.synchronize()
    log(f"kernel parity: fold bit-exact (max abs err {fold_err}), gather "
        f"exact (max abs err {gather_err}) in "
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
    log(f"main path launches: {json.dumps(launches)}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched on the main "
                                 "path")
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
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
