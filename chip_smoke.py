#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 22] [--profile-out PATH]

Phases, each of which raises on failure (so the script exits non-zero
and never prints its last line):

1. device: the card's name and power limit; the build time of all six
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
   edge_gather_ref exactly. The receiver's scatter group-by at btc-14m's
   inbox shape (4 x 18.7 M rows, D = 1: random slots with repeats and 20
   % invalid rows, and no row valid) and small cases (D = 1 to 4, +-inf,
   one hub slot, valid rows at slot Np, past it and below 0, which it
   drops) must match scatter_combine_ref: has, min and max bit for bit,
   sums to rtol 1e-6; a NaN row leaves its slot NaN. The sort group-by's
   fold at the genome cell's inbox (4 x 34.4 M rows sorted by slot, D =
   1, a third valid and none) and small cases (D = 1 to 4, M = 1 and
   ragged, runs across tiles, a run over 586 tiles, slots below 0, at Np
   and past it, +-inf and NaN) must match sort_fold_dense_ref bit for
   bit, sums included. Flash
   attention at the serving prefill's shape (B*H 128, S 2048, hd 128,
   bf16, causal), at gemma3-12b's (B 8, S 2048, 16 heads over 8, hd 240),
   at zamba2-1.2b's shared block's (B 8, S 2048, 32 heads, hd 64),
   stablelm-12b's (32 heads over 8, hd 160) and yi-34b's (56 heads over
   8: a GQA group of 7, hd 128) and small cases (f32 and bf16, causal
   or not, hd 32/64/128 and the head dims the kernel runs padded, 8, 16, 80, 120, 160, 240, and 256,
   ragged S, Sq < Sk, a query block whose second warpgroup holds no row,
   GQA through strided views, also at hd 240 and 120); the grouped matmul at the prefill (T
   65,536 rows, d 2048, f 1408 and back, 64 groups of which 60 live) and
   decode (T 32) shapes, empty groups, one group holding every row, a
   group of one row, a group that ends mid-tile before a non-empty one, T
   below one tile, d 1408, sizes summing below and above T, int32 sizes,
   f32 cases, and llama4-maverick's w_gate (T 16,384 rows top-1 over 128
   experts, d 5120, f 8192). Gradients: each kernel's autograd Function
   against the plain version's autograd on the same inputs and output gradient:
   flash dq, dk, dv at qwen2-moe's training shape (B 8, S 2048, 16 heads
   of hd 128, bf16, causal), hubert-xlarge's (hd 80, non-causal), small
   f32 cases and GQA; the grouped matmul's dX (the kernel on transposed
   weights) and dW at the prefill shape in both orientations, a group of
   one row beside an empty group, f32. Tolerance in the working dtype:
   bf16 2**-6 |want| + 1e-3 (two units in its last place), f32 1e-5
   |want| + 2e-5.
3. graph path at the shape of LDBC Graphalytics' graph500-<scale>
   (Graph500 R-MAT, edge factor 16, P = 4 partitions on one card):
   PageRank (full_outer, 15 iterations) and SSSP from vertex 0
   (left_outer) through load_graph -> run_host -> gather_values, held to
   a scipy float64 power iteration (rtol 1e-4) and to scipy's unweighted
   shortest paths (exact). The counts are set to 0 before the path and
   read after it: the fold's and the gather's must be > 0, and each run
   must launch the receiver's scatter_combine and not sort_fold_dense.
4. CC and PageRank at webmap-tiny's shape (rmat 20k/240k) on the card and
   through the port's plain path on the CPU: CC equal, PageRank within
   rtol 1e-5.
5. graph kernels' timings at the graph path's shapes: kernel, plain and
   library-call ms (CUDA events, median of 20 after warm-up) beside the
   bound ms. The fold over all four partitions' (4, Ep) streams in one
   call, bit-equal to the plain fold and to itself over 20 repeats, with
   scatter_reduce over partition-offset keys as the yardstick; the
   gather over the flattened edge stream in the engine's order and
   shuffled (seeded). After phase 6, the scatter group-by at
   btc-14m.pagerank's inbox (runs of distinct ascending slots, the rest
   invalid), every row valid, and no row valid, against the plain chain
   (torch's scatter_add_ through a sink slot). After phase 10, the sort
   group-by's fold at gage-chr14-k31.pathmerge's inbox, a third of the
   rows valid and none, against its plain chain (the Hillis-Steele
   network and the sink scatters), with its bound.
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
   as the library yardstick, also at gemma3-12b's global layers, hd 240,
   SDPA there on K/V repeated to 16 heads; grouped matmul:
   torch._grouped_mm where this torch has it). Flash also at hubert's
   shape (non-causal, hd 80 run at HD 128), and its backward at qwen's
   training shape beside the plain autograd backward and SDPA's. The
   grouped matmul at prefill in both orientations
   (w_gate/w_up: d 2048 -> f 1408; w_down: d 1408 -> f 2048) and at
   decode: the kernel's wrapper alone (ms), the model's entry point
   (wrapper_ms: one launch, no other op), the host's time to enqueue one
   entry-point call (host_us, the two tensor maps' encoding included),
   and at decode the host's time for one tensor-map encode; its backward
   at prefill: dX through the kernel (and the weights' transposing copy),
   dW a group at a time, the plain autograd backward, torch._grouped_mm.
   Flash also at stablelm-12b's and yi-34b's prefill shapes (SDPA on K/V
   repeated to 32 and 56 heads), the grouped matmul at llama4-maverick's
   w_gate (every expert's weights read: bound by bytes).
10. mutations and the library programs at graph500-20 (phase 11's
   graph, generated first), each run with the counts set to 0 before it
   and read after it: BFS and Reachability from vertex 0 (left-outer +
   sender combine; the fold must launch) equal scipy's hop counts and
   reached set; KCore (k = 48) on graph500-20 made symmetric (33.6 M
   edge slots; fold and gather must launch) equals a scipy peeling to
   its fixed point; PathMerge (16
   rounds) on a 2**22-vertex chain equals the port's CPU path bit for
   bit (run in a child process started after the build, so that it
   overlaps the card phases), conserves its mass, and launches the
   gather and the sort group-by's sort_fold_dense; an insert program at
   the default mutation_cap regrows it and lands on its closed form; a custom (selection) combine at webmap-
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
14. the port's command-line entry point, repro_torch.launch.pregel_run,
   called in this process (run(parse_args([...]), graph=...)) on the
   graphs the earlier phases hold, the counts set to 0 before each run
   and read after it: (a) PageRank at graph500-<scale> with --trace
   --report --explain --metrics --progress: ranks within rtol 1e-5 of
   phase 3's and 1e-4 of scipy, one fold and one gather launch a
   superstep, a valid Chrome trace with a superstep span a superstep, a
   valid run report with an audit row a superstep and no error row; the
   traced median superstep beside phase 3's untraced one and the
   memwatch HBM estimate's peak beside max_memory_allocated, which the
   estimate (shapes only, a lower bound) must not pass. (b) SSSP
   under --auto-plan --explain --metrics --trace: scipy's hop counts,
   phase 12's switch supersteps, a replan decision at each with a
   candidate table of at least two plans, host.plan_switches counting
   them, replan spans. (c) PageRank --ooc on phase 11's graph (P = 8, 2
   on the card, the disk tier at a third of phase 13's peak pager bytes,
   mru, one I/O thread): within rtol 1e-5 of phase 13's streamed run,
   non-zero DRAM and SSD peaks in the report, page-fault spans and spans
   on at least 2 threads. (d) SSSP on --dataset webmap-large under
   --recover --checkpoint-every 3 with REPRO_FAULT_PLAN set to one worker
   failure after superstep 5: one recovery line, the distances of an
   uninterrupted CLI run, the fault in the report's faults section.

15. the sharded driver (repro_torch.core.sharded.run_sharded), every run
   on one RankPool of 2 spawned ranks on the card, the counts set to 0
   before each run and read after it (the ranks' launches, summed and
   each rank's): (a) one rank over NCCL at graph500-<scale>, P = 4:
   PageRank within rtol 1e-5 of phase 3's ranks (bit equality printed)
   and 1e-4 of scipy, SSSP equal to scipy's hop counts, the fold and the
   gather launched in the rank. On phase 11's graph (graph500-20; at
   graph500-22 the script passed 968 s of its 1200), P = 8, loaded once:
   (b) two ranks sharing the card over gloo (NCCL refuses two ranks on
   one GPU): PageRank within rtol 1e-5 and SSSP equal to run_host at P
   = 8 on the card, the kernels launched in both ranks; (c) two ranks
   out of core (2 partitions resident a rank, the DRAM tier): PageRank
   within rtol 1e-5 of phase 11's run_host and 1e-4 of scipy; (d) SSSP
   under recover=True, a snapshot every 5 supersteps and one worker
   failure at superstep 5 raised in the ranks: one recovery onto 1 rank
   (NCCL), scipy's distances; (e) the
   CLI with --devices 2 on webmap-large: one exchange line and the
   single-device CLI run's distances. Prints for each the transport,
   supersteps, median superstep s, run s, job s, the median exchange
   bytes and stall a superstep and each rank's peak device bytes.
16. the production dry run and the graph examples: (a) python -m
   repro_torch.launch.pregel_run --dryrun --scale paper-large --mesh
   both for pagerank, sssp and cc, three subprocesses started together
   (no device; rank 0's superstep on meta tensors over a fake 256- or
   512-rank group): every record status ok, its all-to-all bytes equal
   to M x ((1 + D) x 4 + 1) x (N - 1) / N and its vertex and message
   argument bytes to the capacity formula; prints each record's plan,
   bytes, flops, collective bytes, argument and peak bytes and roofline
   terms. (b) the operator counter's argument + eager peak bytes of
   phase 3's PageRank superstep (meta tensors at its shape) beside the
   max_memory_allocated of phase 3's PageRank run: a reading, no gate.
   (c) examples/{quickstart,pagerank_webmap,path_merge_genomix}_torch.py
   on the card in this process, the counts set to 0 before each and
   read after it: quickstart's SSSP equal to scipy's hop counts (the
   fold launched), the webmap PageRank within rtol 1e-4 of scipy's power
   iteration with its checkpoint repartitioned onto P = 3, PathMerge's
   mass equal to n (both kernels launched in each, and sort_fold_dense
   in PathMerge).
17. the decoders of slice 11 at reduced size (d 128, float32, window 8;
   gemma3-12b cut to 6 layers so that its global layer runs), the same
   weights served on the card and on the CPU, prompts 12 (local rings
   wrap misaligned) and 16, and 6 (within the window) on gemma3 and
   h2o-danube: greedy ids equal, logits within atol 1e-4,
   every decode step on the card within atol 1e-4 of a teacher-forced
   prefill; gemma3 and h2o-danube with int8 K/V caches: codes within one,
   logits within 2e-2.
18. gemma3-12b at full width (48 layers, d 3840, hd 240, window 1024,
   vocab 262144, bf16, ~11.6e9 seeded random parameters) through serve():
   batch 8, prompt 2048, 32 new tokens; exactly 8 flash launches (one a
   global layer); prefill ms, decode ms a token, peak memory, the same
   warm; the last step's logits against a teacher-forced prefill
   (relative L2 <= 0.5); then its 6-layer cut in float32 at prompt 1100,
   every decode step within relative L2 1e-4 of a teacher-forced
   prefill.
19. zamba2-1.2b (6 flash launches a prefill, hd 64) and falcon-mamba-7b
   (64 layers, no cut) at full width as phase 18, then their float32
   cuts (6 and 2 layers) at prompt 300, as phase 18's (falcon's prefill
   not profiled: its scan's 143,255 kernels a call cost the profiler
   about 2 minutes).

20. training: qwen2-moe-a2.7b at full width (d 2048, 60 experts padded
   to 64, top-4, vocab 151,936, bf16, sort dispatch) cut to 4 of 24
   layers (~2.73e9 parameters), through repro_torch.launch.train.train:
   global batch 8, sequence 2048, 8 steps, no checkpoint, the counts set
   to 0 before it and read after it: every loss and grad norm finite, the
   last loss below the first, both kernels launched; prints the loss by
   step, each step's ms, the warm median (steps 3-8) and tokens/s, the
   peak of max_memory_allocated, launches a step, and one more step
   profiled. (b) the same width cut to 2 layers in float32, batch 2,
   sequence 256: one make_train_step on the card and one on the CPU with
   the same weights and batch: loss, grad norm and every updated
   parameter within relative 1e-4. (c) the reduced qwen2-moe trained 4
   steps straight, and 2 steps with a checkpoint then resumed: steps 3-4
   within 1e-5 (loss; parameters relative L2).
21. the frontends: (a) hubert-xlarge at full width and depth (48 layers,
   d 1280, 16 heads of hd 80, non-causal, bf16, ~1.26e9 parameters) on
   seeded frames, batch 8 of 2048: its encode step, then 2 train steps;
   losses finite, flash launched; ms and the peak. (b) its float32 cut (2
   layers, batch 2, 256 frames), one train step card vs CPU as 20 (b).
   (c) internvl2-76b at full width cut to 2 of 80 layers (d 8192, 64
   heads over 8, vocab 128,256, ~3.88e9 parameters) through serve() with
   zero patch embeddings: batch 2, prompt 512, 8 new; ids in range,
   logits finite, flash launched.
22. the last three configs through serve() at batch 8, prompt 2048, 32
   new, as phase 18: stablelm-12b at full width and depth (40 layers, d
   5120, 32 heads over 8 of hd 160, LayerNorm, tied embeddings, ~11.63e9
   parameters; 40 flash launches a prefill, its prefill profiled),
   yi-34b at full width cut to 8 of 60 layers (56 heads over 8, untied
   embeddings) and llama4-maverick-400b-a17b cut to one period of 2 of 48
   layers (a dense and a MoE layer of 128 experts top-1 with a shared
   expert, on the sort dispatch: the grouped matmul launched; ~17.5e9
   parameters); stablelm-12b's float32 2-layer cut at prompt 300, decode
   vs teacher-forced prefill within relative L2 1e-4; the three at
   reduced size card vs CPU: ids equal, logits within atol 1e-4.
23. the LLM production dry run on meta tensors (no device), in
   subprocesses: (a) the three configs' decode_32k cells on the 256-rank
   mesh (python -m repro_torch.launch.dryrun), argument bytes exactly the
   JAX package's, printed beside its flops, temp and collective bytes
   with the ratios; (b) stablelm-12b's prefill at phase 22's batch x
   prompt counted on a one-rank mesh (arguments + eager peak) beside
   phase 22's max_memory_allocated: a reading.

Before its last line it prints its total seconds, the card's nvidia-smi
line and one JSON line with every kernel's name, route, source, the TPU
kernel it replaces, its launches on its main path (and, for the graph
kernels, on phase 12's to 16's runs; for flash, on phase 8's, 17's to
19's, 20's to 21's and 22's; for the grouped matmul, on phase 8's, 20's
and 22's),
max abs err, kernel /
plain / bound / library ms. The last line is {"ok": true, "device":
{...}}.
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
SCATTER_SRC = "src/repro_torch/kernels/csrc/scatter_combine.cu"
SCATTER_REPLACES = ("src/repro/core/groupby.py scatter_combine_dense (XLA's "
                    "scatter; no Pallas kernel)")
SORT_FOLD_SRC = "src/repro_torch/kernels/csrc/sort_fold_dense.cu"
SORT_FOLD_REPLACES = ("src/repro/core/groupby.py sort_combine_dense (XLA's "
                      "associative_scan and dropping scatter; no Pallas "
                      "kernel)")
PACK_SRC = "src/repro_torch/kernels/csrc/bucket_pack.cu"
PACK_REPLACES = ("src/repro/core/connector.py bucket_by_owner (XLA's argsort, "
                 "gathers and dropping scatters; no Pallas kernel)")
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
# gemma3-12b's global layers at the same batch and prompt (phase 18)
GEMMA_FLASH_SHAPE = dict(B=8, S=2048, H=16, KV=8, hd=240)
# zamba2-1.2b's shared block at the same batch and prompt (phase 19)
ZAMBA_FLASH_SHAPE = dict(B=8, S=2048, H=32, KV=32, hd=64)
# qwen2-moe-a2.7b training (causal) and hubert-xlarge (non-causal, hd 80
# run at HD 128) at batch 8, sequence 2048 (phases 20, 21)
TRAIN_FLASH_SHAPE = dict(B=8, S=2048, H=16, KV=16, hd=128)
HUBERT_FLASH_SHAPE = dict(B=8, S=2048, H=16, KV=16, hd=80)
# the last three configs at batch 8, prompt 2048 (phase 22): stablelm-12b's
# attention (hd 160 run at HD 256), yi-34b's (a GQA group of 7) and
# llama4-maverick's MoE w_gate (128 experts, top-1: T = 8 * 2048 rows)
STABLELM_FLASH_SHAPE = dict(B=8, S=2048, H=32, KV=8, hd=160)
YI_FLASH_SHAPE = dict(B=8, S=2048, H=56, KV=8, hd=128)
LLAMA4_GMM_SHAPE = dict(T=16384, d=5120, f=8192, E=128)
YI_LAYERS = 8        # phase 22's yi-34b depth (of 60)
LLAMA4_LAYERS = 2    # phase 22's llama4-maverick depth (of 48): one period
# btc-14m.pagerank's receiver inbox (bench/configs/btc-14m.json, P = 4):
# Np slots a partition, one run of bucket_cap = Np + 8 rows from each of
# the 4 source partitions, each run's valid rows the distinct ascending
# slots of 89 % of the 3,596,989 vertices a partition owns
BTC_INBOX = dict(P=4, Np=4_676_087, runs=4, owned=3_596_989, density=0.89)
# gage-chr14-k31.pathmerge's receiver inbox (bench/configs/gage-chr14-k31.json,
# P = 4): load_graph's Np = int(ceil(91,289,826 / 4) * 1.3) + 1 slots a
# partition; M = 4 runs of bucket_capacity = int((Ep / 4 + 8) * 1.5) rows,
# Ep = GENOME_EP, the most edges a partition holds; a third of the rows
# valid in the two supersteps that send, none in the other seven
GENOME_EP = 22_901_414
GENOME_INBOX = dict(P=4, M=4 * int((GENOME_EP / 4 + 8) * 1.5),
                    Np=29_669_195, valid_share=1 / 3)
# the route's streams (S source partitions of K rows, P = 4 hash owners)
# at the three cells' shapes: the genome's sender combine leaves Ep rows
# a partition (capc >= Ep: no compaction), half of them valid in the two
# supersteps that send and none in the other seven, bucket_cap =
# bucket_capacity; btc-14m's and graph500-22's combines are compacted to
# n_parts x bucket_cap rows. Each stream is dst-ascending (presorted).
ROUTE_SHAPES = {
    "genome": dict(S=4, K=GENOME_EP, cap=int((GENOME_EP / 4 + 8) * 1.5),
                   n=91_289_826, valid_share=0.5),
    "btc-14m": dict(S=4, K=4 * 3_596_989, cap=3_596_989, n=14_386_100,
                    valid_share=0.89),
    "graph500-22": dict(S=4, K=4 * 598_738, cap=598_738, n=2_394_952,
                        valid_share=0.75)}
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


def scatter_stream(P: int, M: int, Np: int, D: int, device, *, seed: int,
                   invalid: float = 0.2, slots: int = 0, nonfinite=False):
    """A receiver inbox of P partitions of M rows: slots drawn from [0,
    ``slots`` or Np) (repeats, in no order), ``invalid`` of the rows
    invalid with their slot set to the sink Np as the engine's _slot_of
    does, payload uniform in [0, 1) (+-inf where ``nonfinite``). Made on
    ``device`` from a seeded generator."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    slot = torch.randint(0, slots or Np, (P, M), generator=g, device=device,
                         dtype=torch.int32)
    valid = torch.rand((P, M), generator=g, device=device) >= invalid
    slot = torch.where(valid, slot, Np)
    pay = torch.rand((P, M, D), generator=g, device=device)
    if nonfinite:
        pick = torch.rand((P, M, D), generator=g, device=device)
        pay[pick < 0.02] = float("inf")
        pay[(pick >= 0.02) & (pick < 0.04)] = float("-inf")
    return slot, pay, valid


def check_scatter(slot, pay, valid, Np: int, op: str, what: str = "",
                  plain=None):
    """The kernel's wrapper against the plain chain on the same tensors:
    has, min and max bit for bit (NaN where NaN), sums to rtol 1e-6
    (atomics add in no fixed order). ``plain`` gives the plain chain's
    inputs where they differ (rows the kernel drops, the chain cannot
    take). -> max abs err of the finite values."""
    import torch
    from repro_torch.kernels.scatter_combine import (scatter_combine,
                                                     scatter_combine_ref)
    got, has_k = scatter_combine(slot, pay, valid, Np, op)
    want, has_p = scatter_combine_ref(*(plain or (slot, pay, valid)), Np, op)
    ok = bool(torch.equal(has_k, has_p))
    if op == "sum":
        ok = ok and bool(torch.allclose(got, want, rtol=1e-6, atol=0,
                                        equal_nan=True))
    else:
        ok = ok and same_bits(got, want)
    if not ok:
        raise AssertionError(
            f"scatter_combine {op} {what} shape {tuple(pay.shape)} Np {Np}: "
            f"kernel != plain (has equal {bool(torch.equal(has_k, has_p))}, "
            f"max abs err {max_abs_err(got, want)})")
    return max_abs_err(got, want)


def scatter_parity(device, inbox=None) -> float:
    """The receiver group-by's kernel against its plain chain: at
    btc-14m's inbox shape (``inbox``: P, Np; M = 4 (Np + 8) rows, D = 1),
    random streams with 20 % invalid rows and repeated slots and an
    all-invalid inbox (the first superstep's), for sum, min and max; then
    small cases: D = 1 to 4, +-inf and NaN payloads, every row at one
    slot, M not a multiple of the kernel's 1024-row block, M = 1, valid
    rows at slot Np, past it and below 0 (the kernel drops them; the
    plain chain is given them as invalid rows)."""
    import torch
    inbox = inbox or BTC_INBOX
    P_, Np = inbox["P"], inbox["Np"]
    M = 4 * (Np + 8)
    err = 0.0
    for op in ("sum", "min", "max"):
        big = scatter_stream(P_, M, Np, 1, device, seed=7)
        err = max(err, check_scatter(*big, Np, op, "btc-14m inbox"))
        slot, pay, valid = big
        none = torch.zeros_like(valid)
        err = max(err, check_scatter(torch.full_like(slot, Np), pay, none,
                                     Np, op, "btc-14m inbox, all invalid"))
        del big, slot, pay, valid, none
        free(device)
        for D in (1, 2, 3, 4):
            for (P_s, M_s, Np_s) in ((1, 1, 5), (3, 1023, 40),
                                     (4, 100_003, 20_000)):
                err = max(err, check_scatter(
                    *scatter_stream(P_s, M_s, Np_s, D, device, seed=D + M_s,
                                    nonfinite=op != "sum"),
                    Np_s, op, f"D={D}"))
            # every row at one of 3 slots: the most contended atomics
            # (a sum over 64 rows a slot: two orders of 10,000 float32
            # adds differ by more than rtol 1e-6)
            hub = 200 if op == "sum" else 50_000
            err = max(err, check_scatter(
                *scatter_stream(2, hub, 1000, D, device, seed=D, slots=3,
                                nonfinite=op != "sum"),
                1000, op, f"hub D={D}"))
        # valid rows at Np, past it and below 0: dropped
        slot, pay, valid = scatter_stream(4, 10_000, 300, 2, device, seed=3)
        g = torch.Generator(device=device).manual_seed(4)
        pick = torch.rand(slot.shape, generator=g, device=device)
        slot = torch.where(pick < 0.05, 300, slot)
        slot = torch.where((pick >= 0.05) & (pick < 0.1), 301, slot)
        slot = torch.where((pick >= 0.1) & (pick < 0.15), 2 ** 31 - 1, slot)
        slot = torch.where((pick >= 0.15) & (pick < 0.2), -1, slot)
        keep = valid & (slot >= 0) & (slot < 300)
        plain = (torch.where(keep, slot, 300), pay, keep)
        # on the CPU both sides are the plain chain, which raises on them
        kern = (slot, pay, valid) if device == "cuda" else plain
        err = max(err, check_scatter(*kern, 300, op, "slots outside [0, Np)",
                                     plain=plain))
    # a NaN stays, whatever comes after it; -0.0 against +0.0
    nan = torch.tensor([[float("nan"), -5.0, float("inf"), 2.0]],
                       device=device)[..., None]
    z = torch.zeros((1, 4), dtype=torch.int32, device=device)
    on = torch.ones((1, 4), dtype=torch.bool, device=device)
    from repro_torch.kernels.scatter_combine import scatter_combine
    for op in ("sum", "min", "max"):
        for order in ([0, 1, 2, 3], [3, 2, 1, 0]):
            got = scatter_combine(z, nan[:, order].contiguous(), on, 1, op)[0]
            if not bool(torch.isnan(got).all()):
                raise AssertionError(f"scatter_combine {op}: a NaN row did "
                                     f"not stay NaN (order {order})")
    return err


def inbox_like_btc(kind: str, seed: int, inbox=None):
    """btc-14m.pagerank's receiver inbox at P = 4 as the exchange leaves
    it: each partition's M = 4 (Np + 8) rows are 4 runs, one a source
    partition; a run's valid rows hold distinct ascending slots (a
    sender combine's output), 89 % of the partition's owned vertices,
    and the rest of the run is invalid at the sink slot Np. kind
    "mixed" is that; "valid" every row valid (each run's slots drawn
    with repeats from the owned range, ascending); "invalid" no row
    valid (the first superstep's). payload uniform, D = 1."""
    import torch
    inbox = inbox or BTC_INBOX
    P_, Np, R, owned = (inbox["P"], inbox["Np"], inbox["runs"],
                        inbox["owned"])
    C = Np + 8
    g = torch.Generator(device="cuda").manual_seed(seed)
    slot = torch.full((P_, R, C), Np, dtype=torch.int32, device="cuda")
    valid = torch.zeros((P_, R, C), dtype=torch.bool, device="cuda")
    for p in range(P_):
        for r in range(R):
            if kind == "mixed":
                s = torch.nonzero(torch.rand(owned, generator=g,
                                             device="cuda")
                                  < inbox["density"])[:, 0]
            elif kind == "valid":
                s = torch.sort(torch.randint(0, owned, (C,), generator=g,
                                             device="cuda")).values
            else:
                continue
            slot[p, r, :len(s)] = s.to(torch.int32)
            valid[p, r, :len(s)] = True
    pay = torch.rand((P_, R * C, 1), generator=g, device="cuda")
    return slot.reshape(P_, R * C), pay, valid.reshape(P_, R * C), Np


def scatter_timing(launches: int, inbox=None) -> dict:
    """The receiver group-by at btc-14m.pagerank's inbox shape: the
    kernel and the plain chain (torch's scatter_add_ with the sink slot)
    on the realistic inbox (runs of distinct ascending slots, the rest
    invalid), on an inbox with every row valid and on one with none
    (the first superstep's), sum over D = 1; kernel equal to the plain
    chain to rtol 1e-6 on each. Bound: 9 B a row (slot, payload, valid
    read) and 5 B a slot (dense and has written)."""
    import torch
    from repro_torch.kernels.scatter_combine import (scatter_combine_cuda,
                                                     scatter_combine_ref)
    res = {}
    for kind in ("mixed", "valid", "invalid"):
        slot, pay, valid, Np = inbox_like_btc(kind, 8, inbox)
        err = check_scatter(slot, pay, valid, Np, "sum", f"btc-14m {kind}")
        res[kind] = dict(
            ms=time_ms(lambda: scatter_combine_cuda(slot, pay, valid, Np,
                                                    "sum")),
            plain_ms=time_ms(lambda: scatter_combine_ref(slot, pay, valid,
                                                         Np, "sum")),
            valid_rows=int(valid.sum()), max_abs_err=err)
        P_, M = slot.shape
        del slot, pay, valid
        free("cuda")
    nbytes = P_ * M * (4 + 4 + 1) + P_ * Np * (4 + 1)
    return dict(name="scatter_combine", route="cuda", source=SCATTER_SRC,
                replaces=SCATTER_REPLACES, launches=launches,
                **res["mixed"], bound_ms=nbytes / MEM_BYTES_PER_S * 1e3,
                bound_by="bytes", all_valid=res["valid"],
                all_invalid=res["invalid"],
                shape=dict(P=P_, M=M, Np=Np, D=1))


def sort_fold_stream(P: int, M: int, Np: int, D: int, device, *, seed: int,
                     valid_share: float = 1 / 3, slots=(0, 0), run: int = 0,
                     nonfinite=False):
    """A sort group-by's streams as ``groupby._sort_rows`` leaves them:
    per partition ``valid_share`` of M rows valid, slots drawn from
    [slots[0], slots[1] or Np) (repeats; below 0 and Np or past it
    dropped), the first ``run`` rows valid at one slot (a run over many
    tiles), payload uniform in [0, 1) (+-inf and NaN where ``nonfinite``);
    sorted stably by slot with the invalid rows keyed int32 max at the
    tail. Made on ``device`` from a seeded generator. -> (keys, payload,
    valid)."""
    import torch
    from repro_torch.core.groupby import _sort_rows
    g = torch.Generator(device=device).manual_seed(seed)
    slot = torch.randint(slots[0], slots[1] or Np, (P, M), generator=g,
                         device=device, dtype=torch.int32)
    valid = torch.rand((P, M), generator=g, device=device) < valid_share
    slot[:, :run] = min(5, Np - 1)
    valid[:, :run] = True
    pay = torch.rand((P, M, D), generator=g, device=device)
    if nonfinite:
        pick = torch.rand((P, M, D), generator=g, device=device)
        pay[pick < 0.02] = float("inf")
        pay[(pick >= 0.02) & (pick < 0.04)] = float("-inf")
        pay[(pick >= 0.04) & (pick < 0.045)] = float("nan")
    return _sort_rows(slot, pay, valid)


def check_sort_fold(keys, pay, valid, Np: int, op: str, what: str = ""):
    """The sort group-by's fold: the kernel's wrapper against its plain
    version (``sort_fold_dense_ref``, the same schedule) on the same
    tensors, dense and has bit for bit (NaN where NaN). -> max abs err of
    the finite values."""
    import torch
    from repro_torch.kernels.sort_fold_dense import (sort_fold_dense,
                                                     sort_fold_dense_ref)
    got, has_k = sort_fold_dense(keys, pay, valid, Np, op)
    want, has_p = sort_fold_dense_ref(keys, pay, valid, Np, op)
    if not (torch.equal(has_k, has_p) and same_bits(got, want)):
        raise AssertionError(
            f"sort_fold_dense {op} {what} shape {tuple(pay.shape)} Np {Np}: "
            f"kernel != plain (has equal {bool(torch.equal(has_k, has_p))}, "
            f"max abs err {max_abs_err(got, want)})")
    return max_abs_err(got, want)


def sort_fold_parity(device, inbox=None) -> float:
    """The sort group-by's fold kernel against its plain version, bit for
    bit: at the genome cell's inbox (``inbox``: P, M, Np, valid_share; D =
    1) with a third of the rows valid and with none, for sum, min and max;
    then small cases: D = 1 to 4, M = 1, below one tile and ragged, runs
    across tiles (every row at one of 3 slots), a run over 586 tiles
    (past the look-back's 128-tile window), valid rows at slots below 0,
    at Np and past it (dropped), every row valid and none, +-inf and NaN
    payloads for min and max."""
    inbox = inbox or GENOME_INBOX
    P_, M, Np = inbox["P"], inbox["M"], inbox["Np"]
    err = 0.0
    for op in ("sum", "min", "max"):
        for share in (inbox["valid_share"], 0.0):
            big = sort_fold_stream(P_, M, Np, 1, device, seed=7,
                                   valid_share=share)
            err = max(err, check_sort_fold(*big, Np, op,
                                           f"genome inbox, {share:.3f} valid"))
            del big
            free(device)
        for D in (1, 2, 3, 4):
            for (P_s, M_s, Np_s, share, slots) in (
                    (1, 1, 5, 1.0, (0, 0)), (3, 300, 40, 0.9, (0, 0)),
                    (4, 1023, 40, 0.7, (0, 0)),
                    (4, 100_003, 20_000, 0.6, (-50, 20_100)),
                    (2, 5_000, 1_000, 1.0, (0, 3)),
                    (3, 4_096, 500, 0.0, (0, 0))):
                err = max(err, check_sort_fold(
                    *sort_fold_stream(P_s, M_s, Np_s, D, device,
                                      seed=D + M_s, valid_share=share,
                                      slots=slots, nonfinite=op != "sum"),
                    Np_s, op, f"D={D} slots {slots} share {share}"))
        err = max(err, check_sort_fold(
            *sort_fold_stream(2, 400_000, 1_000, 1, device, seed=3,
                              valid_share=0.5, run=300_000),
            1_000, op, "a run over 586 tiles"))
    return err


def sort_fold_timing(launches: int, inbox=None) -> dict:
    """The sort group-by's fold at the genome cell's inbox (after the
    sort): the kernel and the plain chain (``groupby.scan_fold_dense``:
    the Hillis-Steele network, scatters through a sink slot) with a third
    of the rows valid and with none, sum over D = 1; the kernel equal to
    its plain version bit for bit on each. Bound: 9 B a valid row (id,
    payload, valid read), one id a tile of the invalid tail, 5 B a slot
    (dense and has written)."""
    import torch
    from repro_torch.core.groupby import scan_fold_dense
    from repro_torch.kernels.sort_fold_dense import sort_fold_dense_cuda
    inbox = inbox or GENOME_INBOX
    P_, M, Np = inbox["P"], inbox["M"], inbox["Np"]
    res = {}
    for kind, share in (("mixed", inbox["valid_share"]), ("invalid", 0.0)):
        ks, ps, vs = sort_fold_stream(P_, M, Np, 1, "cuda", seed=8,
                                      valid_share=share)
        err = check_sort_fold(ks, ps, vs, Np, "sum", f"genome {kind}")
        rows = int(vs.sum())
        tiles = P_ * -(-M // 512) - -(-rows // 512)
        nbytes = rows * (4 + 4 + 1) + tiles * 4 + P_ * Np * (4 + 1)
        res[kind] = dict(
            ms=time_ms(lambda: sort_fold_dense_cuda(ks, ps, vs, Np, "sum")),
            plain_ms=time_ms(lambda: scan_fold_dense(ks, ps, vs, Np,
                                                       torch.add, 0.0),
                             reps=5),
            bound_ms=nbytes / MEM_BYTES_PER_S * 1e3, valid_rows=rows,
            max_abs_err=err)
        del ks, ps, vs
        free("cuda")
    return dict(name="sort_fold_dense", route="cuda", source=SORT_FOLD_SRC,
                replaces=SORT_FOLD_REPLACES, launches=launches,
                **res["mixed"], bound_by="bytes",
                all_invalid=res["invalid"], shape=dict(P=P_, M=M, Np=Np, D=1))


def pack_stream(S: int, K: int, n: int, D: int, device, *, seed: int,
                valid_share: float = 0.5, presorted: bool = True,
                owner_step: int = 1, interleave: bool = False):
    """A route's stream: S rows of K messages, dst drawn from [0, n) in
    steps of ``owner_step`` (``owner_step`` = P puts every row on owner
    0), dst-ascending where ``presorted``, ``valid_share`` of the rows
    valid (every other row where ``interleave``), invalid rows at dst
    -1, payload uniform in [0, 1). Made on ``device`` from a seeded
    generator. -> (dst int32, payload (S, K, D) float32, valid)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    dst = torch.randint(0, max(n // owner_step, 1), (S, K), generator=g,
                        device=device, dtype=torch.int32) * owner_step
    if presorted:
        dst = torch.sort(dst, dim=1).values
    if interleave:
        valid = (torch.arange(K, device=device) % 2 == 0).expand(S, K) \
            .contiguous()
    else:
        valid = torch.rand((S, K), generator=g, device=device) < valid_share
    dst = torch.where(valid, dst, -1)
    pay = torch.rand((S, K, D), generator=g, device=device)
    return dst, pay, valid


def check_pack(dst, pay, valid, P: int, cap: int, what: str = "", **kw):
    """The route's kernel against its plain chain, all four outputs bit
    for bit. With ``kw`` (sort_by_dst, partition, capacity, presorted)
    the whole ``connector.bucket_by_owner`` on ``dst``'s device against
    the same on CPU copies (the chain the CPU tests hold to the JAX
    reference); without, ``bucket_pack`` against ``bucket_pack_ref``
    on the same tensors. -> the valid rows kept."""
    import torch
    from repro_torch.core.connector import bucket_by_owner
    from repro_torch.kernels.bucket_pack import bucket_pack, bucket_pack_ref
    if kw:
        got = bucket_by_owner(dst, pay, valid, P, cap, **kw)
        want = bucket_by_owner(dst.cpu(), pay.cpu(), valid.cpu(), P, cap,
                               **kw)
    else:
        got = bucket_pack(dst, pay, valid, P, cap)
        want = bucket_pack_ref(dst, pay, valid, P, cap)
    names = ("b_dst", "b_payload", "b_valid", "overflow")
    for name, a, b in zip(names, got, want):
        b = b.to(a.device)
        same = same_bits(a, b) if a.is_floating_point() else \
            bool(torch.equal(a, b))
        if not (a.shape == b.shape and a.dtype == b.dtype and same):
            raise AssertionError(
                f"bucket_pack {what} shape {tuple(pay.shape)} P {P} cap {cap}"
                f" {kw}: {name} kernel != plain")
    return int(got[2].sum())


def pack_parity(device, shapes=None) -> int:
    """The route's kernel against its plain chain, bit for bit: at the
    three cells' streams (``shapes``: ROUTE_SHAPES' form), the genome's
    also with no row valid; then small cases: P = 1, 4, 16, 256 and
    4096, D = 1 and 2 (to 4 at P = 4), no row valid, every row on one
    owner, overflow at the cap with every other row invalid, cap >= K
    (at P <= 16), K = 0, 1, one tile
    and past it, streams in no order; then range partitioning (dst
    sorted first, and presorted), the merging connector (sorted first,
    and presorted) through ``bucket_by_owner`` against the CPU chain.
    -> the valid rows kept, summed."""
    shapes = shapes or ROUTE_SHAPES
    kept = 0
    for name, sh in shapes.items():
        for share in ((sh["valid_share"], 0.0) if name == "genome"
                      else (sh["valid_share"],)):
            dst, pay, valid = pack_stream(sh["S"], sh["K"], sh["n"], 1,
                                          device, seed=11,
                                          valid_share=share)
            kept += check_pack(dst, pay, valid, 4, sh["cap"],
                               f"{name}, {share} valid")
            del dst, pay, valid
            free(device)
    for P_ in (1, 4, 16, 256, 4096):
        for D in ((1, 2, 3, 4) if P_ == 4 else (1, 2)):
            # cap >= K only where P C stays small
            for K, cap, share in ((10_007, 7, 0.8),
                                  (10_007, 20_000 if P_ <= 16 else 40, 0.5),
                                  (4096, 300 if P_ <= 16 else 3, 1.0),
                                  (8193, 64, 0.3), (1, 1, 1.0), (0, 5, 1.0)):
                kept += check_pack(*pack_stream(3, K, 50_000, D, device,
                                                seed=P_ + D + K,
                                                valid_share=share,
                                                presorted=K % 2 == 0),
                                   P_, cap, f"D={D} K={K} share {share}")
        kept += check_pack(*pack_stream(2, 30_000, 50_000, 2, device, seed=3,
                                        valid_share=0.0), P_, 50, "none valid")
        kept += check_pack(*pack_stream(2, 30_000, 50_000, 1, device, seed=4,
                                        valid_share=0.9, owner_step=P_),
                           P_, 25_000 if P_ <= 16 else 2_000, "one owner")
        kept += check_pack(*pack_stream(2, 30_000, 50_000, 1, device, seed=5,
                                        interleave=True, presorted=False),
                           P_, max(7_500 // P_, 1), "overflow, interleaved")
    for partition, sort_by_dst in (("range", False), ("range", True),
                                   ("hash", True)):
        for presorted in (False, True):
            for P_, cap in ((4, 150_000), (16, 2_000)):
                n = 500_000
                kw = dict(sort_by_dst=sort_by_dst, partition=partition,
                          capacity=-(-n // P_), presorted=presorted)
                kept += check_pack(*pack_stream(4, 400_000, n, 2, device,
                                                seed=P_ + cap,
                                                valid_share=0.7,
                                                presorted=presorted),
                                   P_, cap, "connector", **kw)
    return kept


def pack_timing(launches: int, shapes=None) -> dict:
    """The route's bucket pack at the three cells' streams (the genome's
    also with no row valid): the kernel and the plain chain (argsort by
    owner, four gathers, searchsorted, scatters through the sink slot),
    D = 1, P = 4; the kernel equal to the chain bit for bit on each.
    Bound: 1 B a row (its flag), 8 B a valid row (dst and payload read),
    9 B a slot (dst, payload and valid written once)."""
    from repro_torch.kernels.bucket_pack import (bucket_pack_cuda,
                                                 bucket_pack_ref)
    shapes = shapes or ROUTE_SHAPES
    res = {}
    for name, sh in shapes.items():
        for kind, share in ((("mixed", sh["valid_share"]), ("invalid", 0.0))
                            if name == "genome"
                            else (("mixed", sh["valid_share"]),)):
            dst, pay, valid = pack_stream(sh["S"], sh["K"], sh["n"], 1,
                                          "cuda", seed=12,
                                          valid_share=share)
            check_pack(dst, pay, valid, 4, sh["cap"], f"{name} {kind}")
            rows = int(valid.sum())
            nbytes = sh["S"] * sh["K"] + rows * 8 + sh["S"] * 4 * sh["cap"] * 9
            res[f"{name} {kind}"] = dict(
                ms=time_ms(lambda: bucket_pack_cuda(dst, pay, valid, 4,
                                                    sh["cap"])),
                plain_ms=time_ms(lambda: bucket_pack_ref(dst, pay, valid, 4,
                                                         sh["cap"]), reps=5),
                bound_ms=nbytes / MEM_BYTES_PER_S * 1e3, valid_rows=rows,
                shape=dict(S=sh["S"], K=sh["K"], C=sh["cap"], P=4, D=1))
            del dst, pay, valid
            free("cuda")
    first = next(iter(res))
    return dict(name="bucket_pack", route="cuda", source=PACK_SRC,
                replaces=PACK_REPLACES, launches=launches, **res[first],
                bound_by="bytes",
                cells={k: v for k, v in res.items() if k != first})


# ------------------------------------------------------------- main

def run_main_path(edges, n, device, stats_out: dict):
    """PageRank + SSSP through the port's entry points on ``device``;
    each run must launch the receiver's scatter_combine kernel and the
    route's bucket_pack."""
    import torch
    from repro_torch.core import gather_values, load_graph, run_host
    from repro_torch.graph import SSSP, PageRank
    from repro_torch.kernels import COUNTERS
    out = {}
    for name, prog, vd in (("pagerank", PageRank(n, iterations=15), 2),
                           ("sssp", SSSP(source=0), 1)):
        vert = load_graph(edges, n, P, value_dims=vd, device=device)
        sync = torch.cuda.synchronize if device == "cuda" else \
            (lambda: None)
        sync()
        mem = {}
        if device == "cuda":   # phase 16 (b) reads the run's peak
            torch.cuda.reset_peak_memory_stats()
            mem = dict(allocated_before_bytes=torch.cuda.memory_allocated())
        before = {k: c.launches for k, c in COUNTERS.items()}
        t0 = time.perf_counter()
        res = run_host(vert, prog, prog.suggested_plan, max_supersteps=60)
        sync()
        if device == "cuda":
            mem["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        walls = [s["wall_s"] for s in res.stats if "wall_s" in s]
        launches = {k: c.launches - before[k] for k, c in COUNTERS.items()}
        need_launches(name, dict(launches=launches),
                      ("scatter_combine", "bucket_pack"), device)
        need_no_launches(name, dict(launches=launches), ("sort_fold_dense",))
        stats_out[name] = dict(
            supersteps=res.supersteps, run_s=time.perf_counter() - t0,
            superstep_median_s=statistics.median(walls),
            superstep_median_after_first_s=(statistics.median(walls[1:])
                                            if len(walls) > 1 else None),
            events=[s["event"] for s in res.stats if "event" in s],
            launches=launches, shape=dict(P=P, Np=vert.vid.shape[1],
                                          Ep=vert.edge_src.shape[1]), **mem)
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

KCORE_K = 48     # graph500-20 made symmetric: neither empty nor whole
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


def need_no_launches(what: str, stats: dict, names):
    """The kernels that ``what``'s plan never calls for."""
    for k in names:
        if stats["launches"][k] != 0:
            raise AssertionError(f"kernel {k} launched on {what}, whose "
                                 "plan does not call for it")


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
    """Phase 10 on ``edges`` (graph500-20): BFS and Reachability from
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

    # KCore on the symmetric multigraph (2 x the edges' slots)
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
    need_launches("PathMerge", st, ("csr_spmv", "sort_fold_dense",
                                     "bucket_pack"), device)
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


def out_of_core_phase(big, small, *, device="cuda", keep=None) -> dict:
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
    and the device busy share of one streamed superstep. ``keep`` (a
    dict) receives the streamed run's ranks on ``small``."""
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
        if keep is not None:
            keep["streamed"] = streamed     # phase 14's reference
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


# ------------------------------------------------------------- phase 14

# one worker failure after superstep 5 (the chaos harness's plan format)
FAULT_PLAN = {"seed": 0, "faults": [{"site": "superstep", "kind": "worker",
                                     "superstep": 5, "worker": 1}]}
# the CLI's lines worth keeping in the log (progress, metrics and the
# audit table stay in the run report and the trace)
CLI_LINES = ("pagerank on", "sssp on", "cc on", "recovery #", "final plan",
             "  superstep", "disk tier", "readiness stall", "report:",
             "trace:", "value head", "exchange:")


def cli(label: str, argv, device, graph=None, pool=None, phase=14):
    """One run of the port's CLI in this process
    (``repro_torch.launch.pregel_run.run``; ``pool`` a RankPool for the
    sharded modes), the counts set to 0 just before it and read just
    after (a sharded run's launches are its ranks'), its standard output
    captured (its summary lines are logged). -> (RunResult, report dict
    or None, stats dict, output text)."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels import COUNTERS
    from repro_torch.launch.pregel_run import parse_args, run
    args = parse_args(list(argv) + ["--device", device])
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    reset_counters()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res, rep = run(args, graph=graph, pool=pool)
    sync()
    run_s = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        if line.startswith(CLI_LINES):
            log(f"phase {phase} {label}: {line}")
    walls = [s["wall_s"] for s in res.stats if "wall_s" in s]
    launches = {k: c.launches for k, c in COUNTERS.items()}
    for w in res.workers:
        for k, v in w["launches"].items():
            launches[k] += v
    # run_s: the CLI call (graph load, run, reports); job_s: the driver's
    return res, rep, dict(
        supersteps=res.supersteps, run_s=run_s, job_s=res.wall_s,
        superstep_median_s=statistics.median(walls),
        launches=launches), text


def check_report(label: str, rep: dict, rows: int) -> dict:
    """The run report is schema-valid with ``rows`` audit rows and no
    ``error`` row (the audit's own swallowed exception)."""
    from repro_torch.obs.report import validate_report
    errs = validate_report(rep)
    if errs:
        raise AssertionError(f"{label}: report violations {errs}")
    audit = [r["audit"] for r in rep["supersteps"] if "audit" in r]
    bad = [a["error"] for a in audit if "error" in a]
    if bad or len(audit) != rows:
        raise AssertionError(f"{label}: {len(audit)} audit rows (want "
                             f"{rows}), error rows {bad}")
    return rep["summary"]


def read_trace(path) -> tuple:
    """-> (trace JSON, its validation summary), the port's validator."""
    from repro_torch.obs.export import validate_chrome_trace
    obj = json.loads(Path(path).read_text())
    return obj, validate_chrome_trace(obj)


def spans_named(obj: dict, names) -> list:
    return [e for e in obj["traceEvents"]
            if e["ph"] == "X" and e["name"] in names]


def cli_phase(big, small, *, phase3: dict, sssp_switches, ooc_streamed,
              pager_peak: int, device="cuda", scale=22,
              small_scale=CKPT_SCALE) -> dict:
    """Phase 14: the port's command-line entry point
    (``repro_torch.launch.pregel_run``) driven in this process on
    ``device``. ``big`` and ``small`` are graph_and_references tuples
    (phase 3's graph and phase 11's); ``phase3`` phase 3's stats (its
    untraced median superstep), ``sssp_switches`` the supersteps of phase
    12's auto SSSP plan switches, ``ooc_streamed`` phase 13's streamed
    PageRank ranks on ``small`` and ``pager_peak`` that run's peak pager
    bytes.
    (a) PageRank in memory with the trace, report, audit, metrics and
    progress on: ranks within rtol 1e-5 of phase 3's and 1e-4 of scipy,
    one fold and one gather launch a superstep, a valid trace with a
    superstep span a superstep, a valid report with an audit row a
    superstep and no error row; the traced median superstep beside
    phase 3's untraced one, the HBM estimate's peak beside
    max_memory_allocated, which it must not pass (it counts shapes
    only). (b) SSSP under --auto-plan: scipy's hop counts,
    phase 12's switches, a replan decision at each with its candidate
    table, host.plan_switches counting them, replan spans. (c) PageRank
    out of core on ``small`` (P = 8, 2 on the card, the disk tier at a
    third of ``pager_peak``, mru, one I/O thread): within rtol 1e-5 of
    ``ooc_streamed``, non-zero DRAM and SSD peaks, fault spans and spans
    on at least 2 threads. (d) SSSP on --dataset webmap-large under
    --recover with REPRO_FAULT_PLAN (one worker failure after superstep
    5): one recovery line, the distances of an uninterrupted run, the
    fault in the report's faults section."""
    import os
    import torch
    from repro_torch.core import gather_values
    from repro_torch.graph.algorithms import INF
    from repro_torch.runtime import faults
    cuda = device == "cuda"
    out = {}
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        # (a) PageRank in memory, every observability output on
        edges, n, values, pr_ref, hops = big
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        res, rep, st, _ = cli("pagerank", [
            "--algo", "pagerank", "--parts", str(P), "--dataset",
            f"graph500-{scale}", "--trace", str(d / "pr_trace.json"),
            "--report", str(d / "pr_report.json"), "--explain",
            "--metrics", "--progress"], device, graph=(edges, n))
        ranks = gather_values(res.vertex, n)[:, 0]
        st["max_rel_err_run_host"] = rel_close(
            ranks, values["pagerank"][:, 0], 1e-5, "CLI PageRank vs run_host")
        st["max_rel_err_scipy"] = rel_close(ranks, pr_ref, 1e-4,
                                            "CLI PageRank vs scipy")
        steps = res.supersteps
        if cuda and not all(st["launches"][k] == steps
                            for k in GRAPH_KERNELS):
            raise AssertionError(f"CLI PageRank: launches {st['launches']}, "
                                 f"want one of each kernel a superstep")
        obj, tsum = read_trace(d / "pr_trace.json")
        n_step = len(spans_named(obj, ("superstep",)))
        if n_step < steps:
            raise AssertionError(f"CLI PageRank trace: {n_step} superstep "
                                 f"spans for {steps} supersteps")
        st["summary"] = check_report("CLI PageRank", json.loads(
            (d / "pr_report.json").read_text()), steps)
        st.update(trace_spans=tsum["spans"], superstep_spans=n_step,
                  untraced_superstep_median_s=phase3["pagerank"][
                      "superstep_median_s"],
                  hbm_estimate_peak_bytes=rep["memory_peaks"]["hbm_bytes"])
        st["traced_over_untraced"] = (st["superstep_median_s"]
                                      / st["untraced_superstep_median_s"])
        if cuda:
            # the estimate counts shapes only, so it is a lower bound of
            # what the allocator held: above the card's peak, it is wrong
            peak = torch.cuda.max_memory_allocated()
            est = st["hbm_estimate_peak_bytes"]
            if not 0 < est <= peak:
                raise AssertionError(f"CLI PageRank: memwatch HBM estimate "
                                     f"{est} B outside (0, max_memory_"
                                     f"allocated {peak} B]")
            st.update(max_memory_allocated=peak,
                      allocated_over_estimate=peak / est)
        out["pagerank"] = st
        log(f"phase 14: PageRank {json.dumps(st)}")
        del res, rep
        free(device)

        # (b) SSSP under the planner
        res, rep, st, _ = cli("sssp", [
            "--algo", "sssp", "--parts", str(P), "--dataset",
            f"graph500-{scale}", "--auto-plan", "--explain", "--metrics",
            "--trace", str(d / "sssp_trace.json")], device,
            graph=(edges, n))
        want = np.where(np.isinf(hops), np.float32(INF), hops) \
            .astype(np.float32)
        bad = int((gather_values(res.vertex, n)[:, 0] != want).sum())
        if bad:
            raise AssertionError(f"CLI SSSP differs from scipy at {bad} "
                                 "vertices")
        switches = [s["superstep"] for s in res.stats
                    if s.get("event") == "plan-switch"]
        replans = [x for x in rep["decisions"] if x["kind"] == "replan"]
        counted = sum(s.get("metrics", {}).get("host.plan_switches", 0)
                      for s in res.stats if "wall_s" in s)
        if switches != list(sssp_switches) \
                or [x["superstep"] for x in replans] != switches \
                or any(len(x["candidates"]) < 2 for x in replans) \
                or counted != len(switches):
            raise AssertionError(
                f"CLI SSSP: switches {switches} (phase 12: "
                f"{list(sssp_switches)}), replans {replans}, "
                f"host.plan_switches {counted}")
        obj, tsum = read_trace(d / "sssp_trace.json")
        n_replan = len(spans_named(obj, ("replan",)))
        if switches and not n_replan:
            raise AssertionError("CLI SSSP trace: no replan span")
        check_report("CLI SSSP", rep, res.supersteps)
        need_launches("CLI SSSP", st, ("segment_combine",), device)
        st.update(switches=switches, plan_switches_metric=counted,
                  candidates=[len(x["candidates"]) for x in replans],
                  replan_spans=n_replan, final_plan=fmt_plan(res.plan))
        out["sssp"] = st
        log(f"phase 14: SSSP {json.dumps(st)}")
        del res, rep
        free(device)

        # (c) PageRank out of core on the disk tier
        s_edges, s_n = small[0], small[1]
        budget = pager_peak // 3
        res, rep, st, _ = cli("ooc", [
            "--algo", "pagerank", "--ooc", "--parts", str(OOC_P),
            "--budget-partitions", str(OOC_BUDGET), "--dataset",
            f"graph500-{small_scale}",
            "--disk-dir", str(d / "spill"), "--memory-budget-bytes",
            str(budget), "--eviction", "mru", "--io-threads", "1",
            "--report", str(d / "ooc_report.json"),
            "--trace", str(d / "ooc_trace.json")], device,
            graph=(s_edges, s_n))
        st["max_rel_err_streamed"] = rel_close(
            gather_values(res.vertex, s_n)[:, 0], ooc_streamed, 1e-5,
            "CLI out-of-core PageRank vs phase 13's streamed run")
        ooc_rep = json.loads((d / "ooc_report.json").read_text())
        check_report("CLI out-of-core PageRank", ooc_rep, res.supersteps)
        peaks = ooc_rep["memory_peaks"]
        if not (peaks.get("dram_resident_bytes", 0) > 0
                and peaks.get("ssd_spill_bytes", 0) > 0):
            raise AssertionError(f"CLI out-of-core peaks: {peaks}")
        obj, tsum = read_trace(d / "ooc_trace.json")
        faulted = spans_named(obj, ("page_fault", "fault_bg"))
        if not faulted or tsum["span_threads"] < 2:
            raise AssertionError(f"CLI out-of-core trace: {len(faulted)} "
                                 f"fault spans, {tsum}")
        need_launches("CLI out-of-core PageRank", st, GRAPH_KERNELS, device)
        st.update(budget_bytes=budget, peaks=peaks,
                  fault_spans=len(faulted),
                  fault_threads=len({e["tid"] for e in faulted}),
                  span_threads=tsum["thread_names"])
        out["ooc_pagerank"] = st
        log(f"phase 14: out-of-core PageRank {json.dumps(st)}")
        del res, rep
        free(device)

        # (d) recovery through the CLI's own dataset path
        res, _, st, _ = cli("sssp_clean", [
            "--algo", "sssp", "--parts", str(P), "--dataset",
            "webmap-large"], device)
        n_large = int((res.vertex.vid >= 0).sum())
        clean = gather_values(res.vertex, n_large)[:, 0]
        out["clean_sssp"] = st
        del res
        os.environ[faults.ENV_PLAN] = json.dumps(FAULT_PLAN)
        try:
            res, rep, st, text = cli("recover", [
                "--algo", "sssp", "--parts", str(P), "--dataset",
                "webmap-large", "--recover", "--checkpoint-every", "3",
                "--checkpoint-dir", str(d / "ckpt"),
                "--report", str(d / "recover_report.json")], device)
        finally:
            del os.environ[faults.ENV_PLAN]
            faults.clear()
        lines = [x for x in text.splitlines() if x.startswith("recovery #")]
        got = gather_values(res.vertex, n_large)[:, 0]
        fl = rep.get("faults", {})
        fired = sum(sp["fired"] for sp in
                    fl.get("injected", {}).get("specs", ()))
        if len(lines) != 1 or not np.array_equal(got, clean) \
                or len(fl.get("recovery", ())) != 1 or fired != 1:
            raise AssertionError(f"CLI recovery: {lines}, equal "
                                 f"{np.array_equal(got, clean)}, faults "
                                 f"{fl}")
        check_report("CLI recovered SSSP", rep,
                     sum(1 for s in res.stats if "wall_s" in s))
        need_launches("CLI recovered SSSP", st, ("segment_combine",), device)
        st.update(recovery=fl["recovery"][0]["restored_from"],
                  healthy_workers=fl["recovery"][0]["healthy_workers"],
                  injected_fired=fired)
        out["recover_sssp"] = st
        log(f"phase 14: recovered SSSP {json.dumps(st)}")
        del res, rep
        free(device)
    return out


# ------------------------------------------------------------- phase 15

SHARD_P = 8          # partitions of the two-rank runs
SHARD_RANKS = 2      # ranks of phase 15's pool (both on the one card)


def sharded_run(prog, vert, pool, devices, plan=None, **kw):
    """One run_sharded of ``prog`` on ``pool``'s ranks, the counts set to
    0 just before it and read just after (the ranks' launches, summed,
    and each rank's). -> (RunResult, stats dict): the transport,
    supersteps, median superstep s, run s (the call: the blocks to the
    ranks and back), job s (the driver's), the median exchange bytes and
    stall a superstep, each rank's peak device bytes."""
    import torch
    from repro_torch.core.sharded import run_sharded
    from repro_torch.kernels import COUNTERS
    sync = torch.cuda.synchronize if vert.vid.is_cuda else (lambda: None)
    sync()
    reset_counters()
    t0 = time.perf_counter()
    res = run_sharded(vert, prog, plan or prog.suggested_plan,
                      devices=devices, pool=pool,
                      max_supersteps=kw.pop("max_supersteps", 100), **kw)
    sync()
    run_s = time.perf_counter() - t0
    recs = [s for s in res.stats if "wall_s" in s]
    launches = {k: c.launches for k, c in COUNTERS.items()}
    for w in res.workers:
        for k, v in w["launches"].items():
            launches[k] += v
    st = dict(
        transport=recs[-1]["transport"], n_workers=recs[-1]["n_workers"],
        supersteps=res.supersteps, run_s=run_s, job_s=res.wall_s,
        superstep_median_s=statistics.median(s["wall_s"] for s in recs),
        exchange_bytes_per_superstep=statistics.median(
            s["exchange_bytes"] for s in recs),
        exchange_stall_median_s=statistics.median(
            s["exchange_stall_s"] for s in recs),
        rank_peak_bytes=[w["peak_bytes"] for w in res.workers],
        rank_launches=[w["launches"] for w in res.workers],
        events=[s["event"] for s in res.stats if "event" in s],
        launches=launches)
    if res.recovery:
        st["recovery"] = [{k: e[k] for k in ("restored_from",
                                             "healthy_workers",
                                             "blacklist")}
                          for e in res.recovery]
    return res, st


def need_rank_launches(what: str, st: dict, names, device):
    """Every rank of a sharded run on the card launched ``names``."""
    if device != "cuda":
        return
    for i, got in enumerate(st["rank_launches"]):
        for k in names:
            if got[k] <= 0:
                raise AssertionError(f"kernel {k} never launched in rank "
                                     f"{i} of {what}")


def sharded_phase(big, small, *, device="cuda", fail_at: int = 5,
                  dataset: str = "webmap-large") -> dict:
    """Phase 15: run_sharded over torch.distributed ranks on the card,
    all from one RankPool of SHARD_RANKS spawned ranks. ``big`` and
    ``small`` are graph_and_references tuples (phase 3's graph with its
    P = 4 run_host values, and phase 11's). (a) one rank over NCCL on
    ``big`` at P = 4: PageRank within rtol 1e-5 of phase 3's ranks (bit
    equality printed) and 1e-4 of scipy, SSSP equal to scipy, the fold
    and the gather launched in the rank. On ``small`` at P = 8, loaded
    once: (b) two ranks sharing the card over gloo: PageRank within
    rtol 1e-5 and SSSP equal to run_host at P = 8 on the card; (c) two
    ranks out of core, 2 partitions resident a rank, the DRAM tier:
    PageRank within rtol 1e-5 of phase 11's run_host and 1e-4 of scipy;
    (d) SSSP under recover=True with a snapshot every ``fail_at``
    supersteps and one worker failure at superstep ``fail_at`` raised in
    the ranks: one recovery onto 1 rank (NCCL), distances equal scipy's.
    (e) the CLI with --devices 2 on ``dataset``: the exchange line, and
    the single-device CLI run's distances."""
    import torch
    from repro_torch.core import gather_values, load_graph, run_host
    from repro_torch.core.sharded import RankPool
    from repro_torch.graph import SSSP, PageRank
    from repro_torch.graph.algorithms import INF
    from repro_torch.runtime import faults
    cuda = device == "cuda"
    out = {}

    def hops_equal(got, hops, what):
        want = np.where(np.isinf(hops), np.float32(INF), hops) \
            .astype(np.float32)
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(f"{what}: differs from scipy at {bad} "
                                 "vertices")

    def transport(st, want, what):
        if cuda and st["transport"] != want:
            raise AssertionError(f"{what}: transport {st['transport']}, "
                                 f"want {want}")

    def show(label, st):
        out[label] = st
        log(f"phase 15: {label} {json.dumps(st)}")

    t = time.perf_counter()
    with RankPool(SHARD_RANKS, device) as pool:
        log(f"phase 15: {SHARD_RANKS} ranks spawned in "
            f"{time.perf_counter() - t:.2f} s")
        # (a) one rank, NCCL, phase 3's shape
        edges, n, values, pr_ref, hops = big
        vert = load_graph(edges, n, P, value_dims=2, device=device)
        res, st = sharded_run(PageRank(n, iterations=15), vert, pool, 1)
        ranks = gather_values(res.vertex, n)[:, 0]
        st["max_rel_err_phase3"] = rel_close(
            ranks, values["pagerank"][:, 0], 1e-5, "sharded x1 PageRank")
        st["bit_equal_phase3"] = bool(np.array_equal(
            ranks, values["pagerank"][:, 0]))
        st["max_rel_err_scipy"] = rel_close(ranks, pr_ref, 1e-4,
                                            "sharded x1 PageRank vs scipy")
        transport(st, "nccl", "(a) PageRank")
        need_rank_launches("sharded x1 PageRank", st, GRAPH_KERNELS, device)
        show("a_pagerank", st)
        del res
        vert = dataclasses.replace(vert, value=vert.value[..., :1].clone())
        res, st = sharded_run(SSSP(source=0), vert, pool, 1)
        dist = gather_values(res.vertex, n)[:, 0]
        hops_equal(dist, hops, "sharded x1 SSSP")
        st["equal_phase3"] = bool(np.array_equal(dist,
                                                 values["sssp"][:, 0]))
        transport(st, "nccl", "(a) SSSP")
        need_rank_launches("sharded x1 SSSP", st, ("segment_combine",),
                           device)
        show("a_sssp", st)
        del res, vert
        free(device)

        # (b) two ranks on the one card over gloo, P = 8
        edges, n, values, pr_ref, hops = small
        vert = load_graph(edges, n, SHARD_P, value_dims=2, device=device)
        vert1 = dataclasses.replace(vert,
                                    value=vert.value[..., :1].clone())
        pr = PageRank(n, iterations=15)
        ref = gather_values(run_host(vert, pr, pr.suggested_plan,
                                     max_supersteps=100).vertex, n)[:, 0]
        free(device)
        res, st = sharded_run(pr, vert, pool, SHARD_RANKS)
        ranks = gather_values(res.vertex, n)[:, 0]
        st["max_rel_err_run_host"] = rel_close(
            ranks, ref, 1e-5, "sharded x2 PageRank vs run_host")
        st["bit_equal_run_host"] = bool(np.array_equal(ranks, ref))
        transport(st, "gloo", "(b) PageRank")
        need_rank_launches("sharded x2 PageRank", st, GRAPH_KERNELS, device)
        show("b_pagerank", st)
        del res, ref
        sssp = SSSP(source=0)
        ref = gather_values(run_host(vert1, sssp, sssp.suggested_plan,
                                     max_supersteps=100).vertex, n)[:, 0]
        free(device)
        res, st = sharded_run(sssp, vert1, pool, SHARD_RANKS)
        dist = gather_values(res.vertex, n)[:, 0]
        if not np.array_equal(dist, ref):
            raise AssertionError("sharded x2 SSSP differs from run_host at "
                                 f"{int((dist != ref).sum())} vertices")
        transport(st, "gloo", "(b) SSSP")
        need_rank_launches("sharded x2 SSSP", st, ("segment_combine",),
                           device)
        show("b_sssp", st)
        del res, ref
        free(device)

        # (c) two ranks out of core, the DRAM tier
        res, st = sharded_run(PageRank(n, iterations=15), vert, pool,
                              SHARD_RANKS, budget_partitions=OOC_BUDGET)
        ranks = gather_values(res.vertex, n)[:, 0]
        st["max_rel_err_run_host"] = rel_close(
            ranks, values["pagerank"][:, 0], 1e-5,
            "sharded out-of-core PageRank vs run_host")
        st["max_rel_err_scipy"] = rel_close(
            ranks, pr_ref, 1e-4, "sharded out-of-core PageRank vs scipy")
        transport(st, "gloo", "(c) PageRank")
        need_rank_launches("sharded out-of-core PageRank", st,
                           GRAPH_KERNELS, device)
        show("c_pagerank_ooc", st)
        del res

        # (d) recovery 2 -> 1: a worker failure at superstep fail_at
        faults.install(faults.FaultPlan.from_json(json.dumps(
            {"seed": 0, "faults": [dict(FAULT_PLAN["faults"][0],
                                        superstep=fail_at,
                                        match="sharded")]})))
        try:
            with tempfile.TemporaryDirectory() as d:
                res, st = sharded_run(SSSP(source=0), vert1, pool,
                                      SHARD_RANKS,
                                      checkpoint_every=fail_at,
                                      checkpoint_dir=d, recover=True)
            fired = faults.summary()["specs"][0]["fired"]
        finally:
            faults.clear()
        hops_equal(gather_values(res.vertex, n)[:, 0], hops,
                   "recovered sharded SSSP")
        if len(res.recovery) != 1 or fired != 1 or \
                res.recovery[0]["healthy_workers"] != 1:
            raise AssertionError(f"sharded recovery: {res.recovery}, "
                                 f"fired {fired}")
        transport(st, "nccl", "(d) the replay")
        need_rank_launches("recovered sharded SSSP", st,
                           ("segment_combine",), device)
        st["injected_fired"] = fired
        show("d_sssp_recovered", st)
        del res, vert, vert1
        free(device)

        # (e) the CLI, --devices 2, on its own dataset
        argv = ["--algo", "sssp", "--parts", str(SHARD_P), "--dataset",
                dataset]
        one, _, _, _ = cli("single", argv, device, phase=15)
        res, _, st, text = cli("sharded", argv + ["--devices",
                                                  str(SHARD_RANKS)],
                               device, pool=pool, phase=15)
        n_large = int((one.vertex.vid >= 0).sum())
        if not np.array_equal(gather_values(res.vertex, n_large),
                              gather_values(one.vertex, n_large)):
            raise AssertionError("CLI --devices 2 differs from the "
                                 "single-device CLI run")
        lines = [x for x in text.splitlines() if x.startswith("exchange:")]
        if len(lines) != 1:
            raise AssertionError(f"CLI --devices 2: exchange lines {lines}")
        recs = [s for s in res.stats if "wall_s" in s]
        st.update(transport=recs[-1]["transport"],
                  n_workers=recs[-1]["n_workers"], exchange_line=lines[0],
                  rank_peak_bytes=[w["peak_bytes"] for w in res.workers],
                  rank_launches=[w["launches"] for w in res.workers])
        transport(st, "gloo", "(e) the CLI")
        need_rank_launches("CLI --devices 2", st, ("segment_combine",),
                           device)
        show("e_cli", st)
        del res, one
        free(device)
    return out


# ------------------------------------------------------------- serving

# ------------------------------------------------------------- phase 16

DRYRUN_ALGOS = ("pagerank", "sssp", "cc")
DRYRUN_SCALE = "paper-large"
# each example (examples/*_torch.py) and the kernels its run must launch
EXAMPLES = {"quickstart": ("segment_combine",),
            "pagerank_webmap": GRAPH_KERNELS,
            "path_merge_genomix": GRAPH_KERNELS + ("sort_fold_dense",)}


def start_dryruns(out_dir) -> dict:
    """Phase 16 (a)'s three dry runs (pregel_run --dryrun --mesh both at
    DRYRUN_SCALE), one subprocess an algorithm, all started at once so no
    process group leaks into this process. -> {algo: Popen}."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return {a: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.pregel_run", "--dryrun",
         "--algo", a, "--scale", DRYRUN_SCALE, "--mesh", "both", "--tag",
         "smoke", "--out", str(out_dir)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a in DRYRUN_ALGOS}


def dryrun_expect(algo: str, chips: int, plan: dict) -> dict:
    """The analytic figures of rank 0's superstep: the all-to-all moves
    M slots of the connector's wire width (dst + payload + valid), (N-1)/N
    of them to other ranks; the vertex and message relations hold the
    capacity formula's slots."""
    from repro_torch.launch.pregel_run import (GRAPH_SCALES,
                                               dryrun_capacities,
                                               make_program)
    n_v, n_e = GRAPH_SCALES[DRYRUN_SCALE]
    prog = make_program(algo, n_v)
    Np, Ep = dryrun_capacities(n_v, n_e, chips)
    cap = int((Ep / chips + 8) * 1.5)
    if plan["sender_combine"]:
        cap = min(cap, Np + 8)
    M = chips * max(cap, 8)
    V, D = prog.value_dims, prog.msg_dims
    return {"all-to-all": 1.0 * M * ((1 + D) * 4 + 1) * (chips - 1) / chips,
            "vertex": Np * (4 + 1 + 4 * V) + Ep * (4 + 4 + 4),
            "message": M * (4 + 4 * D + 1)}


def finish_dryruns(procs: dict, out_dir) -> dict:
    """Wait for the dry runs and hold each record to the analytic
    figures. -> {algo_mesh: what phase 16 prints of it}."""
    out = {}
    for algo, proc in procs.items():
        text, _ = proc.communicate(timeout=300)
        if proc.returncode:
            raise AssertionError(f"dry run {algo} exited "
                                 f"{proc.returncode}:\n{text[-2000:]}")
        for mk, chips in (("single", 256), ("multi", 512)):
            rec = json.loads((Path(out_dir) / f"smoke_pregelix-{algo}_"
                              f"{DRYRUN_SCALE}_{mk}.json").read_text())
            if rec["status"] != "ok" or rec["chips"] != chips:
                raise AssertionError(f"dry run {algo} {mk}: {rec}")
            want = dryrun_expect(algo, chips, rec["plan"])
            got = {"all-to-all":
                   rec["per_device"]["collectives"]["all-to-all"],
                   "vertex": rec["memory"]["arguments"]["vertex"],
                   "message": rec["memory"]["arguments"]["message"]}
            if got != want:
                raise AssertionError(f"dry run {algo} {mk}: counted {got}, "
                                     f"analytic {want}")
            p = rec["plan"]
            out[f"{algo}_{mk}"] = dict(
                chips=chips, probe_s=rec["compile_s"],
                plan=f"{p['join']}/{p['groupby']}/{p['connector']}/"
                     f"sc={int(p['sender_combine'])}",
                bytes=rec["per_device"]["bytes"],
                flops=rec["per_device"]["flops"],
                collectives=rec["per_device"]["collectives"],
                argument_bytes=rec["memory"]["argument_bytes"],
                peak_temp_bytes=rec["memory"]["temp_bytes"],
                roofline={k: rec["roofline"][k] for k in
                          ("compute_s", "memory_s", "collective_s",
                           "dominant")})
    return out


def counter_vs_card(shape: dict, card: dict) -> dict:
    """Phase 16 (b): phase 3's PageRank superstep at its (P, Np, Ep) on
    meta tensors under the operator counter (arguments + eager peak),
    beside the card's max_memory_allocated over phase 3's PageRank run.
    A reading, not a gate."""
    import torch
    from repro_torch.core.driver import default_engine_config, prepare_run
    from repro_torch.core.relations import VertexRel
    from repro_torch.core.superstep import make_superstep
    from repro_torch.graph import PageRank
    from repro_torch.launch import op_cost
    Pn, Np, Ep = shape["P"], shape["Np"], shape["Ep"]
    e = lambda *sh, dt=torch.float32: torch.empty(sh, dtype=dt,
                                                  device="meta")
    i32 = torch.int32
    vert = VertexRel(vid=e(Pn, Np, dt=i32), halt=e(Pn, Np, dt=torch.bool),
                     value=e(Pn, Np, 2), edge_src=e(Pn, Ep, dt=i32),
                     edge_dst=e(Pn, Ep, dt=i32), edge_val=e(Pn, Ep))
    prog = PageRank(1 << 22, iterations=15)
    plan = prog.suggested_plan
    ec, v, m, g = prepare_run(vert, prog, plan,
                              default_engine_config(vert, prog, plan))
    cost = op_cost.measure(make_superstep(prog, plan, ec), v, m, g)
    return dict(counter_argument_bytes=cost.argument_bytes,
                counter_peak_temp_bytes=cost.peak_temp_bytes,
                counter_total_bytes=cost.argument_bytes
                + cost.peak_temp_bytes, **card)


def load_example(name: str):
    import importlib.util
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_examples(device: str) -> dict:
    """Phase 16 (c): each example's main(["--device", device]) in this
    process, the counts set to 0 before it and read after it, held to a
    plain reference: quickstart's SSSP to scipy's hop counts, the webmap
    PageRank within rtol 1e-4 of scipy's float64 power iteration and its
    recovered checkpoint repartitioned onto P = 3, PathMerge's mass equal
    to its n."""
    import torch
    from repro_torch.graph.algorithms import INF
    from repro_torch.kernels import COUNTERS
    out = {}
    for name, need in EXAMPLES.items():
        mod = load_example(name)
        free(device)
        reset_counters()
        t0 = time.perf_counter()
        res = mod.main(["--device", device])
        free(device)
        st = dict(run_s=time.perf_counter() - t0,
                  supersteps=res["result"].supersteps,
                  launches={k: c.launches for k, c in COUNTERS.items()})
        need_launches(f"example {name}", st, need, device)
        if name == "quickstart":
            hops = sssp_reference(res["edges"], res["n"], 0)
            want = np.where(np.isinf(hops), np.float32(INF),
                            hops).astype(np.float32)
            bad = int((res["dist"] != want).sum())
            if bad:
                raise AssertionError(f"quickstart: {bad} distances off "
                                     "scipy's")
            st["reached"] = int(np.isfinite(hops).sum())
        elif name == "pagerank_webmap":
            ref = pagerank_reference(res["edges"], res["n"],
                                     res["iterations"])
            st["max_rel_err"] = rel_close(res["ranks"], ref, 1e-4,
                                          "webmap example PageRank")
            if tuple(res["repartitioned"].vid.shape)[0] != 3:
                raise AssertionError("webmap example: not repartitioned "
                                     "onto P = 3")
            st["recovered_superstep"] = res["recovered_superstep"]
        else:
            if res["mass"] != res["n"]:
                raise AssertionError(f"PathMerge mass {res['mass']} != "
                                     f"{res['n']}")
            st["survivors"] = res["alive"]
        out[name] = st
        del res
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def production_phase(phase3: dict, *, device="cuda") -> dict:
    """Phase 16: (a) the production dry run of pagerank, sssp and cc at
    paper-large on the 256- and 512-rank meshes, in subprocesses, each
    record's all-to-all bytes and argument bytes held to the analytic
    figures; (b) the counter's argument + peak estimate of phase 3's
    PageRank superstep beside the card's max_memory_allocated (no gate);
    (c) the three examples on the card."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_dryruns(tmp)
        try:
            if "max_memory_allocated" in phase3.get("pagerank", {}):
                pr = phase3["pagerank"]
                out["memory"] = counter_vs_card(
                    pr["shape"], {k: pr[k] for k in (
                        "allocated_before_bytes", "max_memory_allocated")})
                log(f"phase 16 (b): {json.dumps(out['memory'])}")
            out["examples"] = run_examples(device)
            for k, v in out["examples"].items():
                log(f"phase 16 (c) example {k}: {json.dumps(v)}")
            out["dryrun"] = finish_dryruns(procs, tmp)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for k, v in out["dryrun"].items():
        log(f"phase 16 (a) dry run {k}: {json.dumps(v)}")
    return out


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
    serving path's prefill shape, gemma3-12b's (hd 240, GQA 16 over 8),
    zamba2-1.2b's shared block (hd 64, 32 heads), stablelm-12b's (hd 160,
    32 over 8), yi-34b's (56 over 8: a group of 7) and small edge cases,
    at every head dim the kernel is built for and at head dims it runs
    padded (8, 16, 80, 120, 160, 240)."""
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
    for dt in (torch.float32, torch.bfloat16):
        for hd in (8, 16, 80, 120, 160, 240, 256):
            for causal in (True, False):
                cases += [(2, 100, 100, hd, causal, dt),
                          (2, 37, 300, hd, causal, dt),
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
        for H, KV, hd in ((16, 16, 128), (8, 2, 128), (4, 1, 128),
                          (16, 8, 240), (4, 2, 120)):
            B, S = 2, 150
            qkv = rnd(B, S, H + 2 * KV, hd, dt=dt)
            q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
            err = max(err, close_in_dtype(
                fa_ops.flash_attention(q, k, v, causal=True),
                fa_ops.attention_gqa_ref(q, k, v, causal=True),
                f"flash_attention GQA H={H} KV={KV} hd={hd} {dt}"))
    # gemma3-12b's global layers and zamba2-1.2b's shared block at the
    # serving batch and prompt
    for name, gs in (("gemma3-12b", GEMMA_FLASH_SHAPE),
                     ("zamba2-1.2b", ZAMBA_FLASH_SHAPE),
                     ("stablelm-12b", STABLELM_FLASH_SHAPE),
                     ("yi-34b", YI_FLASH_SHAPE)):
        q = rnd(gs["B"], gs["S"], gs["H"], gs["hd"], dt=torch.bfloat16)
        k, v = (rnd(gs["B"], gs["S"], gs["KV"], gs["hd"], dt=torch.bfloat16)
                for _ in range(2))
        err = max(err, close_in_dtype(
            fa_ops.flash_attention(q, k, v, causal=True),
            fa_ops.attention_gqa_ref(q, k, v, causal=True),
            f"flash_attention {name} shape {gs}"))
        del q, k, v
    return err


def gmm_case(T: int, d: int, f: int, E: int, live: int, dt, seed: int,
             one_group=False, device="cuda"):
    """Expert-sorted tokens, (E, d, f) weights, and group sizes spread
    over the first ``live`` experts (the rest empty, as the pad experts);
    ``one_group=True`` puts every row in one group, a list gives the
    sizes themselves."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(T, d, generator=g, device=device).to(dt)
    w = (torch.randn(E, d, f, generator=g, device=device) / d ** 0.5).to(dt)
    if isinstance(one_group, list):
        sizes = torch.tensor(one_group, device=device)
    elif one_group:
        sizes = torch.zeros(E, dtype=torch.int64, device=device)
        sizes[min(3, E - 1)] = T
    else:
        eid = torch.randint(0, live, (T,), generator=g, device=device)
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
    # llama4-maverick's w_gate at phase 22's prefill: 128 experts, top-1
    x, w, sizes = llama4_gmm_case(seed=116)
    err = max(err, close_in_dtype(
        grouped_matmul(x, w, sizes), grouped_matmul_ref(x, w, sizes),
        f"moe_gmm llama4-maverick shape {LLAMA4_GMM_SHAPE}"))
    return err


def llama4_gmm_case(seed: int):
    """llama4-maverick's w_gate grouped matmul at phase 22's prefill: T =
    16,384 rows routed top-1, uniformly at random, over 128 experts (d
    5120, f 8192, bf16; the 10.7 GB of weights drawn a block of experts
    at a time). -> (x, w, sizes)."""
    import torch
    sh = LLAMA4_GMM_SHAPE
    T, d, f, E = sh["T"], sh["d"], sh["f"], sh["E"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(T, d, generator=g, device="cuda").bfloat16()
    w = torch.empty(E, d, f, dtype=torch.bfloat16, device="cuda")
    for blk in w.split(16):
        blk.copy_(torch.randn(blk.shape, generator=g, device="cuda")
                  / d ** 0.5)
    eid = torch.randint(0, E, (T,), generator=g, device="cuda")
    return x, w, torch.bincount(eid, minlength=E)


# (shape, causal, dtype) of phase 2's flash gradient cases
FLASH_GRAD_CASES = [
    (TRAIN_FLASH_SHAPE, True, "bfloat16"), (HUBERT_FLASH_SHAPE, False,
                                            "bfloat16"),
    (dict(B=2, S=100, H=4, KV=2, hd=64), True, "float32"),
    (dict(B=1, S=37, H=2, KV=2, hd=32), False, "float32"),
    (dict(B=2, S=150, H=8, KV=2, hd=128), True, "bfloat16")]
# (T, d, f, E, live, dtype, sizes) of its grouped-matmul gradient cases
GMM_GRAD_CASES = [
    (SERVE_SHAPE["T_pre"], SERVE_SHAPE["d"], SERVE_SHAPE["f"],
     SERVE_SHAPE["E"], SERVE_SHAPE["live"], "bfloat16", False),
    (SERVE_SHAPE["T_pre"], SERVE_SHAPE["f"], SERVE_SHAPE["d"],
     SERVE_SHAPE["E"], SERVE_SHAPE["live"], "bfloat16", False),
    (300, 256, 384, 4, 4, "bfloat16", [1, 150, 0, 149]),
    (1000, 128, 64, 16, 8, "float32", False)]


def flash_grad_parity(device="cuda") -> float:
    """FlashAttention (the kernel's forward; its backward, plain torch by
    query block) against the plain version's autograd on the same
    values and output gradient taken in float32: dq, dk, dv within
    ``close_in_dtype`` of the Function's dtype, at qwen2-moe's training
    shape (causal, hd 128, bf16), hubert-xlarge's (non-causal, hd 80),
    small float32 cases and GQA 8 over 2. (The bf16 plain version repeats
    K and V to H heads in bf16, so its autograd rounds each head's dK to
    bf16 before the group's sum; the Function sums the group in float32,
    as the float32 reference does.) ``device="cpu"`` rehearses it."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    g = torch.Generator(device=device).manual_seed(31)
    rnd = lambda *s, dt: torch.randn(*s, generator=g, device=device).to(dt)
    err = 0.0
    for sh, causal, dt in FLASH_GRAD_CASES:
        dt = getattr(torch, dt)
        B, S, H, KV, hd = (sh[k] for k in ("B", "S", "H", "KV", "hd"))
        q = rnd(B, S, H, hd, dt=dt).requires_grad_()
        k, v = (rnd(B, S, KV, hd, dt=dt).requires_grad_() for _ in range(2))
        do = rnd(B, S, H, hd, dt=dt)
        got = torch.autograd.grad(fa_ops.flash_attention(q, k, v,
                                                         causal=causal),
                                  (q, k, v), do)
        qf, kf, vf = (t.detach().float().requires_grad_() for t in
                      (q, k, v))
        want = torch.autograd.grad(fa_ops.attention_gqa_ref(
            qf, kf, vf, causal=causal), (qf, kf, vf), do.float())
        for name, a, b in zip("qkv", got, want):
            err = max(err, close_in_dtype(
                a, b, f"flash_attention d{name} {sh} causal={causal} {dt}"))
        del q, k, v, do, got, want, qf, kf, vf
        free(device)
    return err


def gmm_grad_parity(device="cuda") -> float:
    """GroupedMatmul (dX through the kernel on transposed weights, dW a
    group at a time) against the plain version's autograd on the same
    inputs and output gradient: dX and dW within ``close_in_dtype`` at the
    prefill shape (T 65,536, d 2048 -> f 1408 and back, 64 groups of which
    60 live), a group of one row beside an empty group, and float32."""
    import torch
    from repro_torch.kernels.moe_gmm import (grouped_matmul,
                                             grouped_matmul_ref)
    err = 0.0
    for i, (T, d, f, E, live, dt, one) in enumerate(GMM_GRAD_CASES):
        dt = getattr(torch, dt)
        x, w, sizes = gmm_case(T, d, f, E, live, dt, 200 + i, one, device)
        x.requires_grad_()
        w.requires_grad_()
        dy = torch.randn(T, f, generator=torch.Generator(device=device)
                         .manual_seed(300 + i), device=device).to(dt)
        got = torch.autograd.grad(grouped_matmul(x, w, sizes), (x, w), dy)
        want = torch.autograd.grad(grouped_matmul_ref(x, w, sizes), (x, w),
                                   dy)
        for name, a, b in zip(("dX", "dW"), got, want):
            err = max(err, close_in_dtype(
                a, b, f"moe_gmm {name} T={T} d={d} f={f} sizes={one} {dt}"))
        del x, w, dy, got, want
        free(device)
    return err


def qwen_config(dispatch: str = "sort"):
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-moe-a2.7b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch))


def greedy(cfg, params, prompts, max_new: int, quantize=False,
           caches_out=None):
    """Prefill + greedy decode through the port's step functions, on the
    device of ``params``. -> (ids (B, max_new), logits (B, max_new, V));
    the caches after the last step go into the list ``caches_out``."""
    import torch
    from repro_torch.models import make_decode_step, make_prefill_step
    S = prompts.shape[1]
    tok, caches, logits = make_prefill_step(
        cfg, max_len=S + max_new, quantize=quantize)(
        params, {"tokens": prompts})
    decode = make_decode_step(cfg)
    ids, out = [tok], [logits]
    for i in range(max_new - 1):
        tok, caches, logits = decode(params, tok, caches, S + i)
        ids.append(tok)
        out.append(logits)
    if caches_out is not None:
        caches_out.append(caches)
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
    from repro_torch.models.param import layer_views
    p = layer_views(params["stages"][0])[0]["sub0"]
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


def full_width_f32_teacher_forced(cfg=None, layers: int = 2,
                                  batch: int = 2, prompt_len: int = 300,
                                  seed: int = 11) -> dict:
    """``cfg`` (default qwen2-moe-a2.7b, sort dispatch) at full width cut
    to ``layers`` layers, in float32 (TF32 off), on the card: every decode
    step's logits against a prefill over the prompt plus the tokens
    generated so far. Float32 leaves only the sum order between the two
    paths, so: relative L2 <= 1e-4 and the same greedy ids."""
    import torch
    from repro_torch.models import init_params
    cfg = dataclasses.replace(cfg or qwen_config(), num_layers=layers,
                              dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, g, "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, device="cuda", dtype=torch.int32)
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
    return {"arch": cfg.name, "layers": layers, "batch": batch,
            "prompt_len": prompt_len, "steps": new - 1, "rel_l2_max": worst}


def serving_main_path(batch: int, prompt_len: int, max_new: int, cfg=None):
    """``cfg`` (default qwen2-moe-a2.7b, sort dispatch; bf16, random
    weights from a seeded generator on the card) through
    repro_torch.launch.serve.serve, the counts set to 0 just before it."""
    import torch
    from repro_torch.kernels import COUNTERS
    from repro_torch.launch.serve import serve
    cfg = cfg or qwen_config()
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


def profile_serving(params, cfg, prompts, out, prefill_too=True) -> dict:
    """Where the serving time goes: device time by kernel for one prefill
    of the serving batch (if ``prefill_too``) and for one decode step
    after it."""
    from repro_torch.models import make_decode_step, make_prefill_step
    S = prompts.shape[1]
    prefill = make_prefill_step(cfg, max_len=S + 1)
    decode = make_decode_step(cfg)
    tok, caches, _ = prefill(params, {"tokens": prompts})
    res = {}
    if prefill_too:
        res["prefill"] = profile_kernels(
            lambda: prefill(params, {"tokens": prompts}), 1, out,
            f"{cfg.name} prefill (batch x prompt)")
    res["decode_step"] = profile_kernels(
        lambda: decode(params, tok, caches, S), 3, out,
        f"{cfg.name} decode step")
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


def _bound(flop: float, nbytes: float) -> dict:
    """bound_ms and bound_by of a bf16 function: the larger of its
    operations over the card's peak and its bytes over the memory rate."""
    t_op, t_b = flop / BF16_FLOP_PER_S, nbytes / MEM_BYTES_PER_S
    return dict(bound_ms=max(t_op, t_b) * 1e3,
                bound_by="operations" if t_op > t_b else "bytes",
                flop=flop, bytes=nbytes)


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
    return dict(name="flash_attention", route="cuda", source=FLASH_SRC,
                replaces=FLASH_REPLACES, launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **_bound(flop, nbytes), library_ms=lib_ms,
                library="F.scaled_dot_product_attention(is_causal=True)",
                shape=dict(BH=BH, S=S, hd=hd, dtype="bfloat16"),
                gemma3=flash_timing_gemma(),
                stablelm=flash_timing_gqa(STABLELM_FLASH_SHAPE, "stablelm",
                                          17),
                yi=flash_timing_gqa(YI_FLASH_SHAPE, "yi", 18),
                hubert=flash_timing_hubert(),
                backward=flash_backward_timing())


def flash_timing_gemma() -> dict:
    """flash_attention at gemma3-12b's global layers: B 8, S 2048, 16
    query heads over 8 KV heads of hd 240 (run at HD 256)."""
    return flash_timing_gqa(GEMMA_FLASH_SHAPE, "gemma3", 12)


def flash_timing_gqa(gs: dict, what: str, seed: int) -> dict:
    """flash_attention at a GQA prefill shape ``gs`` (B, S, H over KV
    heads of hd), bf16, causal, through the model's entry point (fa_ops)
    on (B, S, H, hd) tensors. The bound counts the function's work at hd;
    the yardstick is SDPA on the same q and on K/V repeated to H heads
    beforehand (untimed)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.flash_attention import \
        kernel_head_dim
    B, S, H, KV, hd = (gs[k] for k in ("B", "S", "H", "KV", "hd"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(B, S, KV, hd, generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    run_k = lambda: fa_ops.flash_attention(q, k, v, causal=True)
    run_p = lambda: fa_ops.attention_gqa_ref(q, k, v, causal=True)
    err = close_in_dtype(run_k(), run_p(), f"flash_attention {what} timing")
    q4 = q.transpose(1, 2).contiguous()
    k4, v4 = (t.transpose(1, 2).repeat_interleave(H // KV, dim=1)
              .contiguous() for t in (k, v))
    run_l = lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=True)
    ms, plain_ms, lib_ms = time_ms(run_k), time_ms(run_p, reps=5), \
        time_ms(run_l)
    flop = 2 * 2 * hd * (S * (S + 1) // 2) * B * H
    nbytes = (2 * B * S * H + 2 * B * S * KV) * hd * 2
    return dict(shape=dict(gs, dtype="bfloat16",
                           kernel_hd=kernel_head_dim(hd)),
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **_bound(flop, nbytes), library_ms=lib_ms,
                library="F.scaled_dot_product_attention(is_causal=True), "
                        f"K/V repeated to {H} heads")


def flash_timing_hubert() -> dict:
    """The flash kernel at hubert-xlarge's shape: B 8, S 2048, 16 heads of
    hd 80 (run at HD 128), bf16, non-causal, through the model's entry
    point; SDPA on the same tensors in (B, H, S, hd) as the yardstick.
    The bound counts the function's work at hd 80."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    sh = HUBERT_FLASH_SHAPE
    B, S, H, hd = (sh[k] for k in ("B", "S", "H", "hd"))
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn(B, S, H, hd, generator=g, device="cuda")
               .bfloat16() for _ in range(3))
    run_k = lambda: fa_ops.flash_attention(q, k, v, causal=False)
    run_p = lambda: fa_ops.attention_gqa_ref(q, k, v, causal=False)
    err = close_in_dtype(run_k(), run_p(), "flash_attention hubert timing")
    q4, k4, v4 = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    run_l = lambda: F.scaled_dot_product_attention(q4, k4, v4)
    ms, plain_ms, lib_ms = time_ms(run_k), time_ms(run_p, reps=5), \
        time_ms(run_l)
    return dict(shape=dict(sh, dtype="bfloat16", causal=False,
                           kernel_hd=128),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library="F.scaled_dot_product_attention(is_causal=False)",
                **_bound(2 * 2 * hd * S * S * B * H, 4 * B * S * H * hd * 2))


def flash_backward_timing() -> dict:
    """The flash Function's backward (``attention_gqa_backward``: plain
    torch by query block, float32) at qwen2-moe's training shape (B 8, S
    2048, 16 heads of hd 128, bf16, causal), beside the plain version's
    autograd backward and SDPA's backward on the same tensors (each timed
    as autograd.grad over a kept graph). Bound: 2.5 times the forward's
    operations (five products to two), or q, k, v, dO read and dq, dk,
    dv written once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_gqa_backward,
                                                     ops as fa_ops)
    sh = TRAIN_FLASH_SHAPE
    B, S, H, hd = (sh[k] for k in ("B", "S", "H", "hd"))
    g = torch.Generator(device="cuda").manual_seed(14)
    q, k, v, do = (torch.randn(B, S, H, hd, generator=g, device="cuda")
                   .bfloat16() for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    # as autograd calls it: on tensors that build no graph
    run_k = lambda: attention_gqa_backward(q.detach(), k.detach(),
                                           v.detach(), do, causal=True)
    out_p = fa_ops.attention_gqa_ref(q, k, v, causal=True)
    run_p = lambda: torch.autograd.grad(out_p, (q, k, v), do,
                                        retain_graph=True)
    err = max(close_in_dtype(a, b, f"flash backward d{n}") for n, a, b in
              zip("qkv", run_k(), run_p()))
    ms, plain_ms = time_ms(run_k), time_ms(run_p, reps=5)
    del out_p
    q4, k4, v4, do4 = (t.detach().transpose(1, 2).contiguous()
                       for t in (q, k, v, do))
    q4, k4, v4 = (t.requires_grad_() for t in (q4, k4, v4))
    out_l = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    run_l = lambda: torch.autograd.grad(out_l, (q4, k4, v4), do4,
                                        retain_graph=True)
    lib_ms = time_ms(run_l)
    fwd_flop = 2 * 2 * hd * (S * (S + 1) // 2) * B * H
    return dict(shape=dict(sh, dtype="bfloat16", causal=True),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library="F.scaled_dot_product_attention(is_causal=True) "
                        "backward",
                **_bound(2.5 * fwd_flop, 7 * B * S * H * hd * 2))


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
    return gmm_timing_of(x, w, sizes, f"T={T} d={d} f={f}")


def gmm_timing_of(x, w, sizes, what: str) -> dict:
    """Kernel, entry-point, plain and library ms of one grouped matmul,
    the host's µs to enqueue a call, and the bound."""
    import torch
    from repro_torch.kernels.moe_gmm import (grouped_matmul,
                                             grouped_matmul_cuda,
                                             grouped_matmul_ref)
    (T, d), (E, _, f) = x.shape, w.shape
    # the kernel's wrapper alone, and the entry point the model calls
    # (the same one launch, behind the device dispatch) as wrapper_ms
    run_k = lambda: grouped_matmul_cuda(x, w, sizes)
    run_w = lambda: grouped_matmul(x, w, sizes)
    run_p = lambda: grouped_matmul_ref(x, w, sizes)
    err = close_in_dtype(run_k(), run_p(), f"moe_gmm timing inputs {what}")
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
    return dict(ms=ms, wrapper_ms=wrapper_ms, host_us=host_us,
                plain_ms=plain_ms, **_bound(flop, nbytes),
                library_ms=lib_ms, library=lib_name, max_abs_err=err,
                shape=dict(T=T, d=d, f=f, E=E, experts_touched=touched))


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
                w_down=down, decode=dec, backward=gmm_backward_timing(),
                llama4=gmm_timing_llama4())


def gmm_timing_llama4() -> dict:
    """moe_gmm at llama4-maverick's w_gate (phase 22's prefill: T 16,384
    rows top-1 over 128 experts, d 5120, f 8192, bf16): every expert's
    weights read, so the bound is set by bytes."""
    import torch
    x, w, sizes = llama4_gmm_case(seed=119)
    out = gmm_timing_of(x, w, sizes, "llama4-maverick")
    del x, w
    torch.cuda.empty_cache()
    return out


def gmm_backward_timing() -> dict:
    """The grouped matmul's backward at the prefill shape (T 65,536 rows
    of d 2048 -> f 1408 over 64 groups, 60 live; bf16): dX through the
    kernel on (E, f, d) weights (the transposing copy timed on its own),
    dW a group at a time in float32 (``grouped_matmul_dw``, its host read
    of the sizes included), the plain version's autograd backward, and
    torch._grouped_mm for dX.
    Bound of each: 2 T d f operations, or its operands read and result
    written once."""
    import torch
    from repro_torch.kernels.moe_gmm import (grouped_matmul_cuda,
                                             grouped_matmul_dw,
                                             grouped_matmul_ref)
    sh = SERVE_SHAPE
    T, d, f, E, live = (sh[k] for k in ("T_pre", "d", "f", "E", "live"))
    x, w, sizes = gmm_case(T, d, f, E, live, torch.bfloat16, 15)
    dy = torch.randn(T, f, generator=torch.Generator(device="cuda")
                     .manual_seed(16), device="cuda").bfloat16()
    w_t = w.transpose(1, 2).contiguous()
    run_dx = lambda: grouped_matmul_cuda(dy, w_t, sizes)
    run_t = lambda: w.transpose(1, 2).contiguous()
    run_dw = lambda: grouped_matmul_dw(x, dy, sizes, E, torch.bfloat16)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    out_p = grouped_matmul_ref(xr, wr, sizes)
    run_p = lambda: torch.autograd.grad(out_p, (xr, wr), dy,
                                        retain_graph=True)
    dx_p, dw_p = run_p()
    err = max(close_in_dtype(run_dx(), dx_p, "moe_gmm backward dX"),
              close_in_dtype(run_dw(), dw_p, "moe_gmm backward dW"))
    touched = int((sizes > 0).sum())
    flop = 2 * T * d * f
    out = dict(shape=dict(T=T, d=d, f=f, E=E, experts_touched=touched),
               max_abs_err=err, plain_ms=time_ms(run_p, reps=3))
    del out_p, dx_p, dw_p
    lib, lib_name = grouped_mm_library(dy, w_t, sizes)
    out["dx"] = dict(ms=time_ms(run_dx), transpose_copy_ms=time_ms(run_t),
                     library_ms=time_ms(lib) if lib else None,
                     library=lib_name,
                     **_bound(flop, (T * f + touched * f * d + T * d) * 2))
    # torch._grouped_mm's 2-d x 2-d form (offsets cutting the shared T)
    # asserts on the device unless every group's rows are a multiple of 8
    # (16 bytes), which routing does not give: no library call here
    out["dw"] = dict(ms=time_ms(run_dw, reps=5), library_ms=None,
                     library="none: torch._grouped_mm's 2-d x 2-d form "
                             "needs every group a multiple of 8 rows",
                     **_bound(flop, (T * d + T * f + touched * d * f) * 2))
    return out


# ------------------------------------------------------------- phases 17-19

DECODERS = ("gemma3-12b", "h2o-danube-3-4b", "falcon-mamba-7b", "zamba2-1.2b")
WINDOW17 = 8       # phase 17's window: prompts 12 and 16 wrap it
INT8_TOL = 2e-2    # phase 17's int8 logits, card vs CPU (see decoders_...)


def reduced_decoder(arch: str):
    """``arch`` at reduced() size (d 128, float32) with a window of 8;
    gemma3 cut to 6 layers, one whole period (5 local + 1 global), so its
    reduced model reaches the flash kernel."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    if "local" in cfg.attn.pattern:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, window=WINDOW17))
    if arch == "gemma3-12b":
        cfg = dataclasses.replace(cfg, num_layers=6)
    return cfg


def int8_codes_apart(a, b) -> int:
    """The largest difference between two int8 caches' codes."""
    import torch
    worst = 0
    for sa, sb in zip(a, b):
        for name, c in sa.items():
            for key in ("k8", "v8"):
                if key in c:
                    d = (c[key].cpu().int() - sb[name][key].cpu().int())
                    worst = max(worst, int(d.abs().max()))
    return worst


def decoders_card_vs_cpu(device="cuda") -> dict:
    """Phase 17: the four decoders at reduced size (``reduced_decoder``),
    the same weights served on the card and on the CPU, TF32 off, prompts
    of 12 (local rings wrap misaligned) and 16 (aligned), and on gemma3 and
    h2o-danube also 6 (within the window: plain causal), 6 new tokens,
    batch 3: greedy ids equal, logits within atol 1e-4 (float32 through up
    to 6 layers summed in another order; logits of magnitude ~4); on the
    card every decode step's logits within atol 1e-4 of a prefill over the
    prompt and the tokens generated so far, with its argmax. Then gemma3
    and h2o-danube with int8 K/V caches (prompt 12), card vs CPU: codes
    within one (the two sides' K/V differ by float32 rounding, so a value
    at a half-code boundary rounds either way) and logits within 2e-2
    (one code of a row moves a score by ~max|k| / 127 / sqrt(hd)).
    ``device="cpu"`` rehearses it here, the CPU against itself."""
    import copy
    import torch
    from repro_torch.kernels import COUNTERS
    from repro_torch.models import init_params
    out = {}
    for arch in DECODERS:
        cfg = reduced_decoder(arch)
        cpu = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        gpu = copy.deepcopy(cpu).to(device)
        row = {}
        # a prompt within the window (6) takes the plain causal branch
        # (window >= S) on models with local layers
        local = "local" in cfg.attn.pattern
        for S in (6, 12, 16) if local else (12, 16):
            prompts = torch.randint(0, cfg.vocab_size, (3, S),
                                    dtype=torch.int32,
                                    generator=torch.Generator()
                                    .manual_seed(4 + S))
            reset_counters()
            ids_g, log_g = greedy(cfg, gpu, prompts.to(device), 6)
            free(device)
            launches = COUNTERS["flash_attention"].launches
            ids_c, log_c = greedy(cfg, cpu, prompts, 6)
            err = max_abs_err(log_g.cpu(), log_c)
            if not torch.equal(ids_g.cpu(), ids_c) or err > 1e-4:
                raise AssertionError(
                    f"phase 17 {arch} prompt {S}: card ids "
                    f"{ids_g.tolist()} vs CPU {ids_c.tolist()}, logits max "
                    f"abs err {err}")
            tf = 0.0
            for i in range(1, 6):
                seq = torch.cat([prompts.to(device), ids_g[:, :i]], dim=1)
                forced, caches = _forced_prefill(gpu, cfg, seq)
                del caches
                tf = max(tf, max_abs_err(log_g[:, i], forced))
                if not torch.equal(forced.argmax(-1).to(torch.int32),
                                   ids_g[:, i]) or tf > 1e-4:
                    raise AssertionError(
                        f"phase 17 {arch} prompt {S}: decode step {i} vs "
                        f"teacher-forced prefill, max abs err {tf}")
            row[f"prompt_{S}"] = {"card_vs_cpu_max_abs_err": err,
                                  "teacher_forced_max_abs_err": tf,
                                  "flash_launches": launches}
        if local:
            prompts = torch.randint(0, cfg.vocab_size, (3, 12),
                                    dtype=torch.int32,
                                    generator=torch.Generator().manual_seed(9))
            cg, cc = [], []
            ids_g, log_g = greedy(cfg, gpu, prompts.to(device), 6,
                                  quantize=True, caches_out=cg)
            ids_c, log_c = greedy(cfg, cpu, prompts, 6, quantize=True,
                                  caches_out=cc)
            err = max_abs_err(log_g.cpu(), log_c)
            apart = int8_codes_apart(cg[0], cc[0])
            if apart > 1 or err > INT8_TOL:
                raise AssertionError(
                    f"phase 17 {arch} int8: codes {apart} apart, logits max "
                    f"abs err {err}")
            row["int8_prompt_12"] = {
                "card_vs_cpu_max_abs_err": err, "codes_apart": apart,
                "ids_equal": bool(torch.equal(ids_g.cpu(), ids_c))}
        out[arch] = row
        del cpu, gpu
        free(device)
    return out


def decoder_serving(arch, batch: int, prompt_len: int, max_new: int,
                    flash_per_prefill: int, profile_prefill: bool = True,
                    profile_out=None) -> dict:
    """``arch`` (a name: full width and depth; or a config) in bf16 with
    seeded random weights on the card through serve(): prefill ms,
    decode ms a token, peak max_memory_allocated, the flash kernel's
    launches (the counts set to 0 just before serve(), read just after;
    they must be
    ``flash_per_prefill``, one a global or shared-block attention, since
    decode never launches it), finite logits and ids their argmax; then
    the same shapes warm, device time by kernel of one prefill (unless
    ``profile_prefill`` is False) and one decode step, and the last
    decode step's logits against a
    prefill over the prompt and the generated tokens: relative L2 <= 0.5
    as in phase 8 (bf16 through every layer rounds the two paths at other
    places; logits unrelated to each other give ~1.41)."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch) if isinstance(arch, str) else arch
    arch = cfg.name
    t0 = time.perf_counter()
    cfg, res, launches, stats = serving_main_path(batch, prompt_len,
                                                  max_new, cfg)
    stats["serve_call_s"] = time.perf_counter() - t0
    stats["launches"] = launches
    check_serving_output(cfg, res)
    if launches["flash_attention"] != flash_per_prefill:
        raise AssertionError(f"{arch}: flash launches "
                             f"{launches['flash_attention']}, expected "
                             f"{flash_per_prefill}")
    res.caches = None
    stats["warm"] = warm_serving_timings(res.params, cfg, res.prompts,
                                         steps=4)
    stats["profile"] = profile_serving(res.params, cfg, res.prompts,
                                       profile_out, profile_prefill)
    n = res.tokens.shape[1] - 1
    seq = torch.cat([res.prompts, torch.from_numpy(res.tokens[:, :n])
                     .to(res.prompts.device)], dim=1)
    forced, caches = _forced_prefill(res.params, cfg, seq)
    del caches
    dec = res.logits[:, n]
    stats["teacher_forced"] = {
        "rel_l2": rel_l2(dec, forced),
        "argmax_equal": int((dec.argmax(-1) == forced.argmax(-1)).sum()),
        "rows": dec.shape[0]}
    if not stats["teacher_forced"]["rel_l2"] <= 0.5:
        raise AssertionError(f"{arch}: decode vs teacher-forced prefill "
                             f"{stats['teacher_forced']}")
    stats["layers"] = cfg.num_layers
    del res, forced
    torch.cuda.empty_cache()
    return stats


def gemma_phase(profile_out=None) -> dict:
    """Phase 18: gemma3-12b at full width (48 layers, d 3840, 16 heads
    over 8 KV heads of hd 240, d_ff 15360, vocab 262144, 5 local layers of
    window 1024 to each global one; bf16, ~11.6e9 random parameters)
    serving batch 8, prompt 2048, 32 new tokens: 8 flash launches a
    prefill, one a global layer, at hd 240. Then the full width cut to 6
    layers (one period) in float32, batch 1, prompt 1100 (the local rings
    wrap misaligned: 1100 - 1024 is not a multiple of 1024): every decode
    step against a teacher-forced prefill, relative L2 <= 1e-4, the same
    ids."""
    from repro_torch.configs import get_config
    out = {"serving": decoder_serving("gemma3-12b", 8, 2048, 32,
                                      flash_per_prefill=8,
                                      profile_out=profile_out)}
    out["f32_6_layers"] = full_width_f32_teacher_forced(
        get_config("gemma3-12b"), layers=6, batch=1, prompt_len=1100,
        seed=13)
    return out


def ssm_phase(profile_out=None) -> dict:
    """Phase 19: zamba2-1.2b (38 Mamba2 layers, d 2048, the shared block
    of 32 heads of hd 64 after every 6th: 6 flash launches a prefill) and
    falcon-mamba-7b (64 Mamba1 layers, d 4096, d_inner 8192, state 16;
    its sequential scan a Python loop over the tokens of 128-token chunks;
    no depth cut) at full width, bf16, serving batch 8, prompt 2048, 32
    new tokens (falcon's prefill not profiled: its scan's 143,255 kernels
    a call cost the profiler about 2 minutes). Then each cut in float32,
    prompt 300 (not a multiple of the SSD chunk or the scan chunk of
    128): zamba2 to 6
    layers (one shared block), falcon to 2, every decode step against a
    teacher-forced prefill, relative L2 <= 1e-4, the same ids."""
    from repro_torch.configs import get_config
    out = {arch: decoder_serving(arch, 8, 2048, 32, flash_per_prefill=n,
                                 profile_prefill=arch != "falcon-mamba-7b",
                                 profile_out=profile_out)
           for arch, n in (("zamba2-1.2b", 6), ("falcon-mamba-7b", 0))}
    out["zamba2_f32_6_layers"] = full_width_f32_teacher_forced(
        get_config("zamba2-1.2b"), layers=6, seed=14)
    out["falcon_f32_2_layers"] = full_width_f32_teacher_forced(
        get_config("falcon-mamba-7b"), layers=2, seed=15)
    return out


# ------------------------------------------------------------- phase 22

LLM_ARCHS = ("stablelm-12b", "yi-34b", "llama4-maverick-400b-a17b")


def llm_config(arch: str, layers=None, dispatch: str = "sort"):
    """``arch`` from the registry, cut to ``layers`` (None: all), a MoE
    config on the ``dispatch`` group-by (sort: the grouped matmul)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
    return cfg


def llm_card_vs_cpu(device="cuda") -> dict:
    """The three configs at reduced() size (float32; llama4 on the sort
    dispatch), the same weights served on the card and on the CPU, TF32
    off, batch 3, prompt 40, 6 new tokens: greedy ids equal, logits
    within atol 1e-4 (as phase 7). ``device="cpu"`` rehearses it here."""
    import copy
    import torch
    from repro_torch.kernels import COUNTERS
    from repro_torch.models import init_params
    out = {}
    for i, arch in enumerate(LLM_ARCHS):
        cfg = llm_config(arch).reduced()
        cpu = init_params(cfg, torch.Generator().manual_seed(30 + i), "cpu")
        gpu = copy.deepcopy(cpu).to(device)
        prompts = torch.randint(0, cfg.vocab_size, (3, 40),
                                dtype=torch.int32,
                                generator=torch.Generator().manual_seed(40))
        reset_counters()
        ids_g, log_g = greedy(cfg, gpu, prompts.to(device), 6)
        free(device)
        launches = {k: c.launches for k, c in COUNTERS.items()}
        ids_c, log_c = greedy(cfg, cpu, prompts, 6)
        err = max_abs_err(log_g.cpu(), log_c)
        if not torch.equal(ids_g.cpu(), ids_c) or err > 1e-4:
            raise AssertionError(f"phase 22 {arch} reduced: card ids "
                                 f"{ids_g.tolist()} vs CPU "
                                 f"{ids_c.tolist()}, logits max abs err "
                                 f"{err}")
        out[arch] = {"card_vs_cpu_max_abs_err": err,
                     "ids": ids_c[0].tolist(),
                     "launches": {k: launches[k] for k in SERVING_KERNELS}}
        del cpu, gpu
        free(device)
    return out


def llm_phase(profile_out=None) -> dict:
    """Phase 22: (a) stablelm-12b at full width and depth (40 layers, d
    5120, 32 heads over 8 of hd 160 run at HD 256, LayerNorm, tied
    embeddings, vocab 100,352; ~11.63e9 parameters), yi-34b at full width
    cut to 8 of 60 layers (56 heads over 8: a GQA group of 7, untied
    embeddings) and llama4-maverick-400b-a17b at full width cut to one
    period of 2 of 48 layers (one dense, one MoE of 128 experts top-1 and
    a shared expert, on the sort dispatch: the grouped matmul over 128
    groups; ~17.5e9 parameters), each bf16 with seeded random weights
    through serve() at batch 8, prompt 2048, 32 new, as phase 18
    (``decoder_serving``: one flash launch a layer a prefill; stablelm's
    prefill profiled, the others' decode step only). (b) stablelm-12b's
    full width cut to 2 layers in float32 at prompt 300, decode vs a
    teacher-forced prefill within relative L2 1e-4. (c) the three at
    reduced size, card vs CPU (``llm_card_vs_cpu``)."""
    out = {}
    for arch, layers, profile_prefill in (
            ("stablelm-12b", None, True), ("yi-34b", YI_LAYERS, False),
            ("llama4-maverick-400b-a17b", LLAMA4_LAYERS, False)):
        cfg = llm_config(arch, layers)
        out[arch] = decoder_serving(cfg, 8, 2048, 32,
                                    flash_per_prefill=cfg.num_layers,
                                    profile_prefill=profile_prefill,
                                    profile_out=profile_out)
    if not out["llama4-maverick-400b-a17b"]["launches"]["moe_gmm"]:
        raise AssertionError("phase 22: llama4-maverick launched no "
                             "grouped matmul")
    out["stablelm_f32_2_layers"] = full_width_f32_teacher_forced(
        llm_config("stablelm-12b"), layers=2, seed=16)
    out["reduced_card_vs_cpu"] = llm_card_vs_cpu()
    return out


# ------------------------------------------------------------- phase 23

# phase 23 (b)'s shape: phase 22's stablelm-12b prefill
LLM_COUNT_SHAPE = dict(arch="stablelm-12b", batch=8, seq=2048)


def start_llm_dryruns(out_dir) -> dict:
    """Phase 23: (a) the three configs' decode_32k cells on the (16, 16)
    mesh, one dry-run CLI subprocess an arch, and (b) the one-rank count
    of stablelm-12b's prefill (this script's ``--llm-count``), all
    started at once, so no process group leaks into this process.
    -> {name: Popen}."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = lambda argv: subprocess.Popen(
        [sys.executable] + argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    procs = {a: run(["-m", "repro_torch.launch.dryrun", "--arch", a,
                     "--shape", "decode_32k", "--mesh", "single", "--tag",
                     "smoke", "--out", str(out_dir)]) for a in LLM_ARCHS}
    procs["one_rank"] = run([str(ROOT / "chip_smoke.py"), "--llm-count",
                             str(Path(out_dir) / "one_rank.json")])
    return procs


def llm_count(out_path: str, arch: str = LLM_COUNT_SHAPE["arch"],
              batch: int = LLM_COUNT_SHAPE["batch"],
              seq: int = LLM_COUNT_SHAPE["seq"]):
    """Phase 23 (b)'s child: ``arch``'s prefill at ``batch`` x ``seq`` on
    a one-rank (1, 1) mesh over a fake group, on meta DTensors under the
    operator counter (``dryrun.count_cell``) -> JSON at ``out_path``."""
    import logging
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import device_mesh, fake_group
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    t0 = time.perf_counter()
    with fake_group(1):
        mesh = device_mesh((1, 1), ("data", "model"))
        _, args_b, f, note = dryrun.count_cell(
            get_config(arch), ShapeCell("serve", seq, batch, "prefill"),
            mesh)
    Path(out_path).write_text(json.dumps(dict(
        arch=arch, batch=batch, seq=seq, counted=note,
        count_s=time.perf_counter() - t0, argument_bytes=args_b,
        peak_temp_bytes=f["peak_temp_bytes"],
        total_bytes=args_b + f["peak_temp_bytes"],
        matmul_flops=f["matmul_flops"])))


def finish_llm_dryruns(procs: dict, out_dir, card_gb=None) -> dict:
    """Wait for phase 23's children. (a) each record ``ok`` on 256 ranks,
    its argument bytes exactly the JAX package's (``JAX_REFERENCE``),
    its matrix flops and collective bytes > 0, printed beside the JAX
    figures with their ratios (GSPMD's partition is not the port's: no
    gate); (b) the one-rank count's arguments + eager peak beside
    ``card_gb`` (phase 22's max_memory_allocated): a reading."""
    from repro_torch.launch.dryrun import JAX_REFERENCE
    out = {}
    for name, proc in procs.items():
        text, _ = proc.communicate(timeout=300)
        if proc.returncode:
            raise AssertionError(f"phase 23 {name} exited "
                                 f"{proc.returncode}:\n{text[-2000:]}")
    for arch in LLM_ARCHS:
        rec = json.loads((Path(out_dir) / f"smoke_{arch}_decode_32k_single"
                          f".json").read_text())
        ref = JAX_REFERENCE[(arch, "decode_32k", "single")]
        pd, mem = rec["per_device"], rec["memory"]
        if rec["status"] != "ok" or rec["chips"] != 256 or \
                mem["argument_bytes"] != ref[0] or \
                not pd["matmul_flops"] > 0 or not pd["collective_bytes"] > 0:
            raise AssertionError(f"phase 23 {arch}: {rec}")
        out[arch] = dict(
            count_s=rec["count_s"], counted=rec["counted"],
            argument_bytes=mem["argument_bytes"],
            temp_bytes=mem["temp_bytes"], matmul_flops=pd["matmul_flops"],
            collective_bytes=pd["collective_bytes"],
            collectives=pd["collectives"],
            dominant=rec["roofline"]["dominant"],
            bound_s=rec["roofline"]["bound_s"],
            jax=rec["jax_reference"],
            flops_vs_jax=pd["matmul_flops"] / ref[2],
            collective_vs_jax=pd["collective_bytes"] / ref[3],
            temp_vs_jax=mem["temp_bytes"] / ref[1])
    one = json.loads((Path(out_dir) / "one_rank.json").read_text())
    if card_gb is not None:
        one["card_max_memory_allocated_gb"] = card_gb
    out["one_rank_prefill"] = one
    return out


def llm_dryrun_phase(card_gb=None) -> dict:
    """Phase 23: the LLM production dry run on meta tensors (no device):
    ``start_llm_dryruns`` then ``finish_llm_dryruns``."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_llm_dryruns(tmp)
        try:
            return finish_llm_dryruns(procs, tmp, card_gb)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()


# ------------------------------------------------------------- phases 20-21

TRAIN_LAYERS = 4     # phase 20's qwen2-moe-a2.7b depth (of 24)
TRAIN_STEPS = 8
TRAIN_REL = 1e-4     # float32 train step, card vs CPU (relative)
# The same step's updates (new - old), leaf by leaf, relative L2. AdamW's
# first step moves an element by about lr * sign(g), so the parameters
# dilute a gradient's error; the updates do not. A sign error on a share p
# of a leaf reads about 2 * sqrt(p) here: 5e-3 catches p > 6e-6. Sound
# runs read up to 7.65e-4: the summation order's float32 noise on
# gradients near AdamW's eps, where the update is most sensitive to g.
TRAIN_UPDATE_REL = 5e-3
RESUME_REL = 1e-5    # resumed vs uninterrupted run on the card


def _finite(*xs) -> bool:
    return all(np.isfinite(x) for x in xs)


def _peak_gb(device):
    import torch
    return torch.cuda.max_memory_allocated() / 1e9 \
        if device == "cuda" else None


def _reset_peak(device):
    import torch
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def trainer_phase(cfg=None, steps: int = TRAIN_STEPS, batch: int = 8,
                  seq: int = 2048, device="cuda", profile_out=None) -> dict:
    """Phase 20: ``cfg`` (default qwen2-moe-a2.7b at full width, sort
    dispatch, cut to TRAIN_LAYERS layers; bf16, seeded random weights)
    through repro_torch.launch.train.train: global batch 8, sequence 2048,
    ``steps`` steps, no checkpoint, the counts set to 0 just before the
    call and read just after. Every step's loss and grad norm finite, the
    last loss below the first (examples/train_lm.py's assertion), both
    kernels launched. Then one more step profiled: device busy share and
    top device kernels."""
    import torch
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.kernels import COUNTERS
    from repro_torch.launch.train import train
    from repro_torch.models import make_train_step
    cfg = cfg or dataclasses.replace(qwen_config(), num_layers=TRAIN_LAYERS)
    _reset_peak(device)
    reset_counters()
    t0 = time.perf_counter()
    res = train(cfg, steps=steps, global_batch=batch, seq_len=seq,
                log_every=1, seed=0, device=device)
    call_s = time.perf_counter() - t0
    launches = {k: COUNTERS[k].launches for k in SERVING_KERNELS}
    loss = [r["loss"] for r in res.steps]
    gnorm = [r["grad_norm"] for r in res.steps]
    if not _finite(*loss, *gnorm):
        raise AssertionError(f"trainer: non-finite loss {loss} or grad "
                             f"norm {gnorm}")
    if not loss[-1] < loss[0]:
        raise AssertionError(f"trainer: the loss did not fall: {loss}")
    if device == "cuda":
        check_launches("training", launches, SERVING_KERNELS)
    warm_s = statistics.median(r["wall_s"] for r in res.steps[2:])
    out = dict(arch=cfg.name, layers=cfg.num_layers, batch=batch, seq=seq,
               steps=steps, params=sum(p.numel() for p in
                                       res.params.parameters()),
               loss=loss, grad_norm=gnorm,
               step_ms=[r["wall_s"] * 1e3 for r in res.steps],
               warm_step_ms=warm_s * 1e3,
               tokens_per_s=batch * seq / warm_s, train_call_s=call_s,
               launches=launches,
               launches_per_step={k: v / steps for k, v in launches.items()},
               max_memory_allocated_gb=_peak_gb(device))
    if device == "cuda":
        step = make_train_step(cfg, total_steps=steps, warmup=5)
        b = {k: torch.from_numpy(v).to(device) for k, v in TokenStream(
            DataConfig(cfg.vocab_size, seq, batch, seed=1)).next_batch()
             .items()}
        out["profile"] = profile_kernels(
            lambda: step(res.params, res.opt_state, b), 1, profile_out,
            f"{cfg.name} train step ({cfg.num_layers} layers)")
    del res
    free(device)
    return out


def token_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    """numpy: the token stream's first batch; an audio model's frames
    (standard normal) and labels instead."""
    from repro_torch.data import DataConfig, TokenStream
    if cfg.frontend == "audio":
        r = np.random.default_rng(seed)
        return {"frames": r.standard_normal((batch, seq, cfg.d_model))
                .astype(np.float32),
                "labels": r.integers(0, cfg.vocab_size, (batch, seq))
                .astype(np.int32)}
    return TokenStream(DataConfig(cfg.vocab_size, seq, batch,
                                  seed=seed)).next_batch()


def train_card_vs_cpu(cfg, batch: int = 2, seq: int = 256, seed: int = 21,
                      device="cuda") -> dict:
    """``cfg`` in float32 (TF32 off): the same weights (drawn on the card,
    copied to the host) and batch, one make_train_step on the card
    (kernels) and one on the CPU (plain versions). Loss and grad norm
    within relative TRAIN_REL, and every updated parameter within
    relative L2 TRAIN_REL, and every leaf's update (new - old) within
    relative L2 TRAIN_UPDATE_REL. ``device="cpu"`` rehearses it, the CPU
    against itself."""
    import torch
    from repro_torch.kernels import COUNTERS
    from repro_torch.models import ParamTree, init_params, make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(cfg, dtype="float32")
    card = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                       device)
    host = ParamTree(tree_map(lambda t: t.detach().cpu().clone(), card))
    b = token_batch(cfg, batch, seq, seed)
    step = make_train_step(cfg, warmup=5, total_steps=10)
    res = {}
    for side, p, dev in (("card", card, device), ("cpu", host, "cpu")):
        before = [t.detach().clone() for t in tree_leaves(p)]
        reset_counters()
        t0 = time.perf_counter()
        _, _, m = step(p, adamw_init(p),
                       {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        res[side] = dict(metrics={k: float(v) for k, v in m.items()},
                         seconds=time.perf_counter() - t0,
                         launches={k: COUNTERS[k].launches
                                   for k in SERVING_KERNELS},
                         delta=[t.detach() - o for t, o in
                                zip(tree_leaves(p), before)])
        del before
    params_rel = max(rel_l2(a.detach().cpu(), b_.detach()) for a, b_ in
                     zip(tree_leaves(card), tree_leaves(host)))
    update_rel = max(rel_l2(a.cpu(), b_) for a, b_ in
                     zip(res["card"]["delta"], res["cpu"]["delta"])
                     if float(b_.norm()) > 0)
    mc, mh = res["card"]["metrics"], res["cpu"]["metrics"]
    out = dict(arch=cfg.name, layers=cfg.num_layers, batch=batch, seq=seq,
               params=sum(t.numel() for t in tree_leaves(host)),
               card=mc, cpu=mh, params_rel_l2_max=params_rel,
               update_rel_l2_max=update_rel,
               loss_rel=abs(mc["loss"] - mh["loss"]) / abs(mh["loss"]),
               grad_norm_rel=abs(mc["grad_norm"] - mh["grad_norm"])
               / mh["grad_norm"],
               card_s=res["card"]["seconds"], cpu_s=res["cpu"]["seconds"],
               launches=res["card"]["launches"])
    if not (out["loss_rel"] <= TRAIN_REL and out["grad_norm_rel"] <= TRAIN_REL
            and params_rel <= TRAIN_REL
            and update_rel <= TRAIN_UPDATE_REL):
        raise AssertionError(f"float32 train step, card vs CPU: {out}")
    del card, host, res
    free(device)
    return out


def resume_check(cfg=None, steps: int = 4, batch: int = 4, seq: int = 64,
                 device="cuda") -> dict:
    """Phase 20 (c): ``cfg`` (default the reduced qwen2-moe, sort
    dispatch) trained ``steps`` steps straight, and trained 2 steps with a
    checkpoint at step 2, then resumed from it to ``steps``: the resumed
    steps' losses within RESUME_REL (absolute) of the straight run's,
    every parameter within relative L2 RESUME_REL (atomics' sum order
    aside, the same operations on the same values)."""
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_leaves
    cfg = cfg or qwen_config().reduced()
    kw = dict(global_batch=batch, seq_len=seq, log_every=1, seed=3,
              device=device)
    whole = train(cfg, steps=steps, **kw)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        train(cfg, steps=2, ckpt_dir=d, ckpt_every=2, **kw)
        save_s = time.perf_counter() - t0
        resumed = train(cfg, steps=steps, ckpt_dir=d, resume=True, **kw)
    loss_err = max(abs(a["loss"] - b["loss"]) for a, b in
                   zip(resumed.steps, whole.steps[2:]))
    rel = max(rel_l2(a.detach(), b.detach()) for a, b in
              zip(tree_leaves(resumed.params), tree_leaves(whole.params)))
    out = dict(arch=cfg.name, steps=steps,
               resumed_steps=[r["step"] for r in resumed.steps],
               loss=[r["loss"] for r in whole.steps],
               loss_max_abs_err=loss_err, params_rel_l2_max=rel,
               first_run_with_save_s=save_s)
    if out["resumed_steps"] != list(range(3, steps + 1)) or \
            loss_err > RESUME_REL or rel > RESUME_REL:
        raise AssertionError(f"resume vs uninterrupted: {out}")
    return out


def hubert_phase(cfg=None, batch: int = 8, seq: int = 2048, steps: int = 2,
                 device="cuda") -> dict:
    """Phase 21 (a): ``cfg`` (default hubert-xlarge at full width and
    depth: 48 layers, d 1280, 16 heads of hd 80, non-causal; bf16, seeded
    random weights) on seeded frames: the encode step (make_prefill_step's
    encoder branch), then ``steps`` make_train_step steps, the counts set
    to 0 just before. Every loss finite, flash launched; ms of each and the
    peak of max_memory_allocated."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import COUNTERS
    from repro_torch.models import (init_params, make_prefill_step,
                                    make_train_step)
    from repro_torch.optim import adamw_init
    cfg = cfg or get_config("hubert-xlarge")
    g = torch.Generator(device=device).manual_seed(41)
    params = init_params(cfg, g, device)
    b = {"frames": torch.randn((batch, seq, cfg.d_model), generator=g,
                               device=device),
         "labels": torch.randint(0, cfg.vocab_size, (batch, seq),
                                 generator=g, device=device,
                                 dtype=torch.int32)}
    _reset_peak(device)
    reset_counters()
    sync = (lambda: torch.cuda.synchronize()) if device == "cuda" else \
        (lambda: None)
    sync()
    t0 = time.perf_counter()
    enc = float(make_prefill_step(cfg)(params, b))
    sync()
    encode_ms = (time.perf_counter() - t0) * 1e3
    enc_launches = COUNTERS["flash_attention"].launches
    step = make_train_step(cfg, warmup=5, total_steps=10)
    opt = adamw_init(params)
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, _, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: COUNTERS[k].launches for k in SERVING_KERNELS}
    out = dict(arch=cfg.name, layers=cfg.num_layers, batch=batch, seq=seq,
               params=sum(p.numel() for p in params.parameters()),
               encode_loss=enc, encode_ms=encode_ms, train_loss=losses,
               train_step_ms=ms, encode_flash_launches=enc_launches,
               launches=launches, max_memory_allocated_gb=_peak_gb(device))
    if not _finite(enc, *losses):
        raise AssertionError(f"hubert: non-finite loss {out}")
    if device == "cuda" and not (enc_launches > 0
                                 and launches["flash_attention"] > 0):
        raise AssertionError(f"hubert: flash never launched {out}")
    del params, opt, b
    free(device)
    return out


def internvl_phase(cfg=None, batch: int = 2, prompt_len: int = 512,
                   max_new: int = 8, device="cuda") -> dict:
    """Phase 21 (c): ``cfg`` (default internvl2-76b at full width, cut to
    2 of 80 layers: d 8192, 64 heads over 8, d_ff 28,672, vocab 128,256,
    256 patch positions; bf16) through serve(), fed zero patch embeddings
    as the JAX serve loop does, the counts set to 0 just before: ids in
    range and the logits' argmax, logits finite, flash launched."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import COUNTERS
    from repro_torch.launch.serve import serve
    cfg = cfg or dataclasses.replace(get_config("internvl2-76b"),
                                     num_layers=2)
    _reset_peak(device)
    reset_counters()
    res = serve(cfg, preset="full", batch=batch, prompt_len=prompt_len,
                max_new=max_new, seed=0, device=device)
    launches = {k: COUNTERS[k].launches for k in SERVING_KERNELS}
    check_serving_output(cfg, res)
    if device == "cuda":
        check_launches("internvl2 serving", launches, ("flash_attention",))
    out = dict(arch=cfg.name, layers=cfg.num_layers, batch=batch,
               prompt_len=prompt_len, max_new=max_new,
               params=sum(p.numel() for p in res.params.parameters()),
               prefill_ms=res.prefill_s * 1e3,
               decode_ms_per_token=res.decode_s_per_token * 1e3,
               launches=launches, max_memory_allocated_gb=_peak_gb(device),
               ids=res.tokens[0].tolist())
    del res
    free(device)
    return out


def training_phases(profile_out=None) -> dict:
    """Phases 20 and 21 on the card, in order; -> their results."""
    from repro_torch.configs import get_config
    out = {}
    t = time.perf_counter()
    out["trainer"] = trainer_phase(profile_out=profile_out)
    log(f"phase 20: trainer {json.dumps(out['trainer'])}")
    out["f32_card_vs_cpu"] = train_card_vs_cpu(
        dataclasses.replace(qwen_config(), num_layers=2))
    log(f"phase 20 (b): float32 train step, card vs CPU "
        f"{json.dumps(out['f32_card_vs_cpu'])}")
    out["resume"] = resume_check()
    log(f"phase 20 (c): resume {json.dumps(out['resume'])}")
    log(f"phase 20: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    out["hubert"] = hubert_phase()
    log(f"phase 21 (a): hubert-xlarge {json.dumps(out['hubert'])}")
    out["hubert_f32_card_vs_cpu"] = train_card_vs_cpu(
        dataclasses.replace(get_config("hubert-xlarge"), num_layers=2))
    log(f"phase 21 (b): hubert float32 train step, card vs CPU "
        f"{json.dumps(out['hubert_f32_card_vs_cpu'])}")
    out["internvl2"] = internvl_phase()
    log(f"phase 21 (c): internvl2-76b {json.dumps(out['internvl2'])}")
    log(f"phase 21: {time.perf_counter() - t:.1f} s")
    return out


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
    ap.add_argument("--llm-count", default=None,
                    help=argparse.SUPPRESS)   # phase 23 (b)'s child
    args = ap.parse_args(argv)
    if args.path_merge_cpu:
        path_merge_cpu(args.path_merge_cpu[0], int(args.path_merge_cpu[1]))
        return 0
    if args.llm_count:
        llm_count(args.llm_count)
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
    """Phases 2-23 on the card; ``child`` is phase 10's CPU PathMerge."""
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
    scatter_err = scatter_parity("cuda")
    torch.cuda.synchronize()
    sort_fold_err = sort_fold_parity("cuda")
    torch.cuda.synchronize()
    pack_kept = pack_parity("cuda")
    torch.cuda.synchronize()
    flash_err = flash_parity()
    torch.cuda.synchronize()
    gmm_err = gmm_parity()
    torch.cuda.synchronize()
    flash_grad_err = flash_grad_parity()
    gmm_grad_err = gmm_grad_parity()
    log(f"kernel parity: fold bit-exact (max abs err {fold_err}), gather "
        f"exact (max abs err {gather_err}), scatter_combine (max abs err "
        f"{scatter_err}), sort_fold_dense bit-exact (max abs err "
        f"{sort_fold_err}), bucket_pack bit-exact ({pack_kept} rows "
        f"kept), flash_attention (max abs err "
        f"{flash_err}), moe_gmm (max abs err {gmm_err}); gradients: "
        f"flash_attention (max abs err {flash_grad_err}), moe_gmm (max abs "
        f"err {gmm_grad_err}) in {time.perf_counter() - t:.1f} s")

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
    # the receiver group-by at btc-14m.pagerank's inbox (5, continued)
    kernels.append(scatter_timing(launches["scatter_combine"]))
    log(f"scatter_combine timing: {json.dumps(kernels[-1])}")
    torch.cuda.empty_cache()
    # the route's bucket pack at the three cells' streams (5, continued)
    kernels.append(pack_timing(launches["bucket_pack"]))
    log(f"bucket_pack timing: {json.dumps(kernels[-1])}")
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

    # 10. mutations and the library programs at graph500-20 (phase 11's
    # graph; at -22 its four graph loads took 150 s of the script)
    t = time.perf_counter()
    ck_scale = min(args.scale, CKPT_SCALE)
    small = graph_and_references(ck_scale)
    small_s = time.perf_counter() - t
    phase10 = mutations_and_programs(small[0], small[1], small[4], child)
    log(f"phase 10: {time.perf_counter() - t:.1f} s (graph500-{ck_scale} "
        f"and its references {small_s:.1f} s); launches by path: "
        + json.dumps({k: v["launches"] for k, v in phase10.items()
                      if "launches" in v}))
    # the sort group-by's fold at the genome cell's inbox (5, continued),
    # with the launches of its main path, phase 10's PathMerge
    kernels.append(sort_fold_timing(
        phase10["path_merge"]["launches"]["sort_fold_dense"]))
    log(f"sort_fold_dense timing: {json.dumps(kernels[-1])}")
    torch.cuda.empty_cache()

    # 11. checkpoints and recovery, at graph500-20 (the snapshots' zlib
    # time at -22 took a quarter of the script)
    t = time.perf_counter()
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
    big = (edges, n, values, pr_ref, hops)
    kept = {}
    phase13 = out_of_core_phase(big, small, keep=kept)
    ooc_paths = {f"ooc_{k}": v["launches"] for k, v in phase13.items()
                 if "launches" in v}
    log(f"phase 13: {time.perf_counter() - t:.1f} s; launches by path: "
        + json.dumps(ooc_paths))
    by_path.update(ooc_paths)

    # 14. the port's CLI on the card, in this process
    t = time.perf_counter()
    phase14 = cli_phase(
        big, small, phase3=stats,
        sssp_switches=[sw[0] for sw in phase12["sssp"]["switches"]],
        ooc_streamed=kept.pop("streamed"),
        pager_peak=phase13["pagerank_streamed"]["pager_peak_bytes"],
        scale=args.scale, small_scale=ck_scale)
    cli_paths = {f"cli_{k}": v["launches"] for k, v in phase14.items()}
    log(f"phase 14: {time.perf_counter() - t:.1f} s; launches by path: "
        + json.dumps(cli_paths))
    by_path.update(cli_paths)

    # 15. the sharded driver over torch.distributed ranks on the card
    t = time.perf_counter()
    phase15 = sharded_phase(big, small)
    shard_paths = {f"sharded_{k}": v["launches"]
                   for k, v in phase15.items()}
    log(f"phase 15: {time.perf_counter() - t:.1f} s; launches by path: "
        + json.dumps(shard_paths))
    by_path.update(shard_paths)

    # 16. the production dry run (no device), the counter's memory
    # estimate beside the card's, the examples on the card
    t = time.perf_counter()
    phase16 = production_phase(stats)
    ex_paths = {f"example_{k}": v["launches"]
                for k, v in phase16["examples"].items()}
    log(f"phase 16: {time.perf_counter() - t:.1f} s; launches by path: "
        + json.dumps(ex_paths))
    by_path.update(ex_paths)
    for k in kernels:
        if k["name"] in GRAPH_KERNELS:
            k["launches_by_path"] = {p: counts[k["name"]]
                                     for p, counts in by_path.items()}
        if k["name"] in ("sort_fold_dense", "bucket_pack"):
            k["launches_by_path"] = {
                p: v["launches"][k["name"]] for p, v in phase10.items()
                if "launches" in v} | {
                p: counts[k["name"]] for p, counts in by_path.items()}
    del edges, values, small, big
    torch.cuda.empty_cache()

    # 17. the decoders of slice 11 at reduced size, card vs CPU
    t = time.perf_counter()
    phase17 = decoders_card_vs_cpu()
    log(f"phase 17: {json.dumps(phase17)}")
    log(f"phase 17: {time.perf_counter() - t:.1f} s")

    # 18. gemma3-12b at full width
    t = time.perf_counter()
    phase18 = gemma_phase(args.profile_out)
    log(f"phase 18: gemma3-12b serving {json.dumps(phase18['serving'])}")
    log(f"phase 18: float32, 6 layers, decode vs teacher-forced prefill: "
        f"{json.dumps(phase18['f32_6_layers'])}")
    log(f"phase 18: {time.perf_counter() - t:.1f} s")

    # 19. zamba2-1.2b and falcon-mamba-7b at full width
    t = time.perf_counter()
    phase19 = ssm_phase(args.profile_out)
    for k, v in phase19.items():
        log(f"phase 19: {k} {json.dumps(v)}")
    log(f"phase 19: {time.perf_counter() - t:.1f} s")
    # 20-21. training qwen2-moe-a2.7b; the audio and vision frontends
    phase2x = training_phases(args.profile_out)

    # 22. stablelm-12b, yi-34b and llama4-maverick served at full width
    t = time.perf_counter()
    phase22 = llm_phase(args.profile_out)
    for k, v in phase22.items():
        log(f"phase 22: {k} {json.dumps(v)}")
    log(f"phase 22: {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()

    # 23. the LLM production dry run on meta tensors (no device)
    t = time.perf_counter()
    phase23 = llm_dryrun_phase(
        phase22["stablelm-12b"]["max_memory_allocated_gb"])
    for k, v in phase23.items():
        log(f"phase 23: {k} {json.dumps(v)}")
    log(f"phase 23: {time.perf_counter() - t:.1f} s")
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    gmm = next(k for k in kernels if k["name"] == "moe_gmm")
    llama4 = phase22["llama4-maverick-400b-a17b"]["launches"]
    gmm["launches_by_path"] = {
        "qwen2-moe-a2.7b serving": s_launches["moe_gmm"],
        f"llama4-maverick serving ({LLAMA4_LAYERS} layers)":
            llama4["moe_gmm"],
        "phase 22 reduced configs": sum(
            r["launches"]["moe_gmm"]
            for r in phase22["reduced_card_vs_cpu"].values()),
        f"qwen2-moe-a2.7b training ({TRAIN_LAYERS} layers, {TRAIN_STEPS} "
        "steps)": phase2x["trainer"]["launches"]["moe_gmm"]}
    flash["launches_by_path"] = {
        "qwen2-moe-a2.7b serving": s_launches["flash_attention"],
        "phase 17 reduced decoders (prompts 12, 16)": sum(
            r[f"prompt_{S}"]["flash_launches"] for r in phase17.values()
            for S in (12, 16)),
        "gemma3-12b serving (hd 240)":
            phase18["serving"]["launches"]["flash_attention"],
        "zamba2-1.2b serving (hd 64)":
            phase19["zamba2-1.2b"]["launches"]["flash_attention"],
        "falcon-mamba-7b serving":
            phase19["falcon-mamba-7b"]["launches"]["flash_attention"],
        f"qwen2-moe-a2.7b training ({TRAIN_LAYERS} layers, {TRAIN_STEPS} "
        "steps)": phase2x["trainer"]["launches"]["flash_attention"],
        "hubert-xlarge encode + 2 train steps (hd 80)":
            phase2x["hubert"]["launches"]["flash_attention"],
        "internvl2-76b serving (2 layers)":
            phase2x["internvl2"]["launches"]["flash_attention"],
        "stablelm-12b serving (hd 160)":
            phase22["stablelm-12b"]["launches"]["flash_attention"],
        f"yi-34b serving ({YI_LAYERS} layers, 56 heads over 8)":
            phase22["yi-34b"]["launches"]["flash_attention"],
        f"llama4-maverick serving ({LLAMA4_LAYERS} layers)":
            llama4["flash_attention"],
        "phase 22 reduced configs": sum(
            r["launches"]["flash_attention"]
            for r in phase22["reduced_card_vs_cpu"].values())}
    log(f"chip_smoke: {time.perf_counter() - T0:.1f} s in all")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
