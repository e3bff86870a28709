"""The production dry run of the model configs: each (arch x shape x
mesh) cell's step counted for rank 0 of the 256-rank (16, 16) or
512-rank (2, 16, 16) production mesh, on meta DTensors over a fake
process group: no data, no device.

    python -m repro_torch.launch.dryrun --arch stablelm-12b \\
        --shape decode_32k --mesh single [--out DIR]
    python -m repro_torch.launch.dryrun --all --mesh both --out DIR

The counterpart of the JAX package's ``launch/dryrun.py``, with its
flags, file names (``{tag}_{arch}_{shape}_{mesh}.json``; an existing
file is skipped), statuses (``ok`` / ``skipped`` / ``error``) and record
keys. Where the JAX package lowers and compiles the step over a
512-device host platform and reads XLA's memory analysis and its HLO,
the port runs the step (``specs.cell_inputs``, ``specs.step_fn_for``;
``models/sharded.py``) under ``op_cost``'s counter:

* ``memory``: ``argument_bytes``, the inputs' local shards (what XLA's
  ``argument_size_in_bytes`` holds); ``temp_bytes``, the counter's eager
  peak (no fusion and no buffer reuse: not XLA's temp); ``output_bytes``;
  ``total_per_device_bytes``, arguments + temp;
* ``per_device``: the counter's ``flops`` (matrix products, and one a
  element elsewhere), ``matmul_flops`` (the matrix products alone: what
  the reference's HLO analyzer counts as flops), ``bytes``, and the
  collective bytes by kind (the ring formulas);
* ``xla_cost_analysis_flops`` is null: there is no XLA. There is no
  lowering or compile either: ``lower_s`` is null, and ``compile_s``
  and ``count_s`` are the counter's seconds;
* ``counted``: ``full`` (every layer and microbatch run) or ``scaled``
  (each stage's period run at 1 and 2 repeats, a train step at 2 and 3
  microbatches of the cell's microbatch size, every figure extrapolated
  linearly to the cell's repeats and microbatches, as the reference's
  HLO analyzer scales a loop body by its trip count; the temp peak is
  extrapolated over the layers alone, an estimate); on the multi mesh the
  count runs with pod and data merged (``FLAT_NOTE``);
* ``roofline``: priced with ``H100_MACHINE`` (``planner/cost.py``), its
  compute term from ``matmul_flops``; its link term a placeholder
  (``machine.net_bw_is``);
* ``jax_reference``: for the cells in ``JAX_REFERENCE``, the JAX
  package's figures (printed beside the port's, not a target: its
  partition is GSPMD's, the port's DTensor's).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
import traceback
from pathlib import Path

from repro_torch.configs import ALL_ARCHS, SHAPES, get_config, runnable_cells
from repro_torch.configs.base import ShapeCell

# The JAX package's figures for the last three configs' cells, a device
# of each mesh: XLA's argument and temp bytes, and its HLO analyzer's
# flops and collective bytes (repro.launch.hlo_cost.analyze). Made on the
# CPU with jax 0.9.0, where repro.launch.dryrun.run_cell's own mesh
# (jax.make_mesh: Explicit axes) raises ShardingTypeError, so over the
# same mesh with Auto axes:
#   mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:n],
#                        axis_types=(AxisType.Auto,) * len(shape))
#   with mesh:
#       kind, args = repro.launch.specs.cell_inputs(cfg, cell, mesh)
#       fn = repro.launch.specs.step_fn_for(cfg, kind, mesh)
#       c = jax.jit(fn).lower(*args).compile()
#   c.memory_analysis(), hlo_cost.analyze(c.as_text())
# under XLA_FLAGS=--xla_force_host_platform_device_count=512.
# (arch, shape, mesh) -> (argument_bytes, temp_bytes, flops,
# collective_bytes)
JAX_REFERENCE = {
    ("stablelm-12b", "train_4k", "single"):
        (12193619972, 10699853392, 453290848419840.0,
         884801332219.0),
    ("stablelm-12b", "train_4k", "multi"):
        (12193357828, 5479636560, 226645424209920.0,
         474954036251.0),
    ("stablelm-12b", "prefill_32k", "single"):
        (2440208384, 8568177736, 201004597903360.0,
         209938140400.0),
    ("stablelm-12b", "prefill_32k", "multi"):
        (2440077312, 15393883184, 1184337360322560.0,
         255346724080.0),
    ("stablelm-12b", "decode_32k", "single"):
        (5795389476, 11853591936, 32914800640.0,
         49204160.0),
    ("stablelm-12b", "decode_32k", "multi"):
        (4117667860, 8393245056, 16457400320.0,
         24602080.0),
    ("yi-34b", "train_4k", "single"):
        (5482983428, 4262530560, 2580008329543680.0,
         10700903208937.0),
    ("yi-34b", "train_4k", "multi"):
        (5482721284, 4350055384, 2580008329543680.0,
         10722246547497.0),
    ("yi-34b", "prefill_32k", "single"):
        (1098141696, 8309048704, 4076783072051200.0,
         360576103664.0),
    ("yi-34b", "prefill_32k", "multi"):
        (1098010624, 8309048848, 4076783072051200.0,
         1384828779760.0),
    ("yi-34b", "decode_32k", "single"):
        (5124411428, 10598780520, 108357222400.0,
         5595899192.0),
    ("yi-34b", "decode_32k", "multi"):
        (3111145492, 6488247912, 54178611200.0,
         5425308316.0),
    ("llama4-maverick-400b-a17b", "train_4k", "single"):
        (10370323972, 15722002128, 1320613859819520.0,
         4673258543193.5),
    ("llama4-maverick-400b-a17b", "train_4k", "multi"):
        (10370061828, 15867664320, 1279382173777920.0,
         4939302357145.5),
    ("llama4-maverick-400b-a17b", "prefill_32k", "single"):
        (3458834944, 35888255552, 2278179761438720.0,
         934023603760.0),
    ("llama4-maverick-400b-a17b", "prefill_32k", "multi"):
        (3458703872, 35888255984, 2278179761438720.0,
         1763520941616.0),
    ("llama4-maverick-400b-a17b", "decode_32k", "single"):
        (6679798308, 14081070352, 431637463040.0,
         10800727352.0),
    ("llama4-maverick-400b-a17b", "decode_32k", "multi"):
        (5069185556, 10770322512, 409092259840.0,
         10722672796.0),
}

TEMP_NOTE = ("eager peak of the bytes operator outputs hold alive beyond "
             "the arguments (launch/op_cost.py): no fusion and no buffer "
             "reuse, not XLA's temp_size_in_bytes")
NET_NOTE = ("net_bw is a placeholder (the HBM copy rate), not a measured "
            "link between cards (ROADMAP item 11, PERF.md section 7)")
# figures the scaled count extrapolates
_FIGURES = ("flops", "matmul_flops", "bytes", "coll_bytes", "output_bytes",
            "peak_temp_bytes")


def _mesh(mesh_kind: str):
    from repro_torch.launch.mesh import make_production_mesh
    return make_production_mesh(multi_pod=(mesh_kind == "multi"))


# DTensor plans a redistribution on a 3-D mesh by a graph search (the
# batch over two axes makes strided shards): a minute and more a cell
FLAT_NOTE = ("; on the mesh with pod and data merged, (32, 16): a "
             "\"data\"-sharded parameter is sharded over both, and the "
             "batch's collectives run over 32 ranks in one group")


def _flat_mesh(mesh):
    """``mesh`` (pod, data, model) as (pod * data, model), named
    (data, model)."""
    from repro_torch.launch.mesh import device_mesh
    names = tuple(mesh.mesh_dim_names)
    size = lambda a: mesh.size(names.index(a))
    return device_mesh((size("pod") * size("data"), size("model")),
                       ("data", "model"))


def _figures(cost) -> dict:
    out = {k: float(getattr(cost, k)) for k in _FIGURES}
    out.update({f"coll:{k}": float(v) for k, v in cost.coll_detail.items()})
    return out


def _measure(cfg, cell: ShapeCell, mesh, causal_mode: str,
             microbatches=None):
    from repro_torch.launch import op_cost
    from repro_torch.launch.specs import cell_inputs, step_fn_for
    kind, args = cell_inputs(cfg, cell, mesh)
    fn = step_fn_for(cfg, kind, mesh, causal_mode=causal_mode,
                     microbatches=microbatches)
    return kind, args, op_cost.measure(fn, *args)


def _with_repeats(cfg, r: int):
    """``cfg`` with its first stage's period repeated ``r`` times (the
    tail stage, if any, kept)."""
    from repro_torch.models.model import stage_plan
    period, repeats = stage_plan(cfg)[0]
    rem = cfg.num_layers - repeats * len(period)
    return dataclasses.replace(cfg, num_layers=r * len(period) + rem)


def _local_rows(args) -> int:
    """Rows of the batch rank 0 holds (the train step's microbatches take
    at most one a row)."""
    batch = args[-1]
    return next(iter(batch.values())).to_local().shape[0]


def count_cell(cfg, cell: ShapeCell, mesh, *,
               causal_mode: str = "masked_full", counted: str = "auto"):
    """Count ``cfg``'s ``cell`` step on ``mesh`` (a DeviceMesh over a
    process group) for rank 0. ``counted``: "full", "scaled", or "auto"
    (scaled when the first stage repeats more than twice or a train
    step runs more than two microbatches). -> (kind, argument bytes of
    the full cell's inputs, the figures, the count's note)."""
    from repro_torch.launch import op_cost
    from repro_torch.launch.specs import cell_inputs, microbatches_for
    from repro_torch.models.model import stage_plan
    kind, args = cell_inputs(cfg, cell, mesh)
    arg_bytes = op_cost.nbytes(args)
    repeats = stage_plan(cfg)[0][1]
    mb = 1
    if kind == "train":
        mb = max(1, min(microbatches_for(cfg), _local_rows(args)))
    del args
    flat = ""
    if "pod" in tuple(mesh.mesh_dim_names):
        mesh, flat = _flat_mesh(mesh), FLAT_NOTE
    if counted == "auto":
        counted = "scaled" if repeats > 2 or mb > 2 else "full"
    if counted == "full":
        _, _, cost = _measure(cfg, cell, mesh, causal_mode)
        return kind, arg_bytes, _figures(cost), "full" + flat
    per_mb = cell.global_batch // mb
    # microbatch points: a step of one microbatch skips the float32
    # accumulation that two or more run, so a line through 2 and 3
    ms = (1,) if mb == 1 else ((2,) if mb == 2 else (2, 3))
    c = {}
    for r in (1, 2):
        for m in ms:
            sub = dataclasses.replace(cell, global_batch=per_mb * m)
            _, _, cost = _measure(_with_repeats(cfg, r), sub, mesh,
                                  causal_mode, microbatches=m)
            c[r, m] = _figures(cost)
    keys = set().union(*(f.keys() for f in c.values()))
    line = lambda v0, v1, x0, x1, x: v0 + (x - x0) * (v1 - v0) / (x1 - x0)
    out = {}
    for k in keys:
        at = [line(c[1, m].get(k, 0.0), c[2, m].get(k, 0.0), 1, 2, repeats)
              for m in ms]
        out[k] = at[0] if len(ms) == 1 else line(*at, *ms, mb)
    # the temp peak: a microbatch's buffers are freed before the next
    # one's, so it grows with the layers only
    p1, p2 = (c[r, ms[-1]]["peak_temp_bytes"] for r in (1, 2))
    out["peak_temp_bytes"] = p1 + (repeats - 1) * max(0.0, p2 - p1)
    note = (f"scaled: the first stage's period at 1 and 2 of its {repeats} "
            f"repeats" + (f", {' and '.join(map(str, ms))} of {mb} "
                          f"microbatches of {per_mb} rows" if mb > 1 else "")
            + ", extrapolated linearly" + flat)
    return kind, arg_bytes, out, note


def run_cell(arch: str, shape: str, mesh_kind: str, *,
             causal_mode: str = "masked_full", out_dir: Path = None,
             tag: str = "baseline") -> dict:
    """One cell's record (the reference's keys, see the module's
    docstring): rank 0's step on meta DTensors over a fake group of the
    mesh's size. ``out_dir`` is unused here (``main`` writes the file),
    as in the reference."""
    from repro_torch.launch.mesh import fake_group
    from repro_torch.planner.cost import H100_MACHINE as mach
    cfg = get_config(arch)
    cell = SHAPES[shape]
    skip = runnable_cells(cfg)[shape]
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "tag": tag,
           "causal_mode": causal_mode}
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    pm = _mesh(mesh_kind)
    chips = pm.n_ranks
    t0 = time.time()
    with fake_group(chips):
        mesh = pm.device_mesh()
        kind, arg_bytes, f, note = count_cell(cfg, cell, mesh,
                                              causal_mode=causal_mode)
    count_s = time.time() - t0
    tokens = cell.global_batch * (cell.seq_len if kind in ("train",
                                                           "prefill")
                                  else 1)
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    mult = 6 if kind == "train" else 2
    model_flops = mult * n_active * tokens
    mm = f["matmul_flops"]
    terms = {"compute_s": mm / mach.peak_flops,
             "memory_s": f["bytes"] / mach.hbm_bw,
             "collective_s": f["coll_bytes"] / mach.net_bw}
    bound = max(terms.values())
    temp = int(round(f["peak_temp_bytes"]))
    rec.update({
        "status": "ok",
        "kind": kind,
        "chips": chips,
        "counted": note,
        "lower_s": None,
        "compile_s": round(count_s, 2),
        "count_s": round(count_s, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": int(round(f["output_bytes"])),
            "temp_bytes": temp,
            "total_per_device_bytes": arg_bytes + temp,
            "temp_is": TEMP_NOTE,
        },
        "per_device": {
            "flops": f["flops"],
            "matmul_flops": mm,
            "bytes": f["bytes"],
            "collective_bytes": f["coll_bytes"],
            "collectives": {k[5:]: v for k, v in f.items()
                            if k.startswith("coll:")},
        },
        "xla_cost_analysis_flops": None,
        "roofline": {
            **terms,
            "dominant": max(terms, key=terms.get),
            "bound_s": bound,
            "model_flops_total": model_flops,
            "model_flops_per_device": model_flops / chips,
            "useful_flops_ratio": (model_flops / chips) / max(mm, 1),
            "roofline_fraction": (model_flops / chips / mach.peak_flops)
            / max(bound, 1e-30),
        },
        "machine": {"name": "H100_MACHINE", "peak_flops": mach.peak_flops,
                    "hbm_bw": mach.hbm_bw, "net_bw": mach.net_bw,
                    "net_bw_is": NET_NOTE},
        "params": n_params,
        "active_params": n_active,
    })
    ref = JAX_REFERENCE.get((arch, shape, mesh_kind))
    if ref is not None:
        rec["jax_reference"] = dict(zip(
            ("argument_bytes", "temp_bytes", "flops", "collective_bytes"),
            ref))
    return rec


def describe(rec: dict) -> str:
    """One line of an ``ok`` record, with the JAX package's figures beside
    the port's where the record has them."""
    r, m, p = rec["roofline"], rec["memory"], rec["per_device"]
    line = (f"  ok count={rec['count_s']}s "
            f"mem/dev={m['total_per_device_bytes'] / 2**30:.2f}GiB "
            f"args={m['argument_bytes']} matmul_flops={p['matmul_flops']:.4e}"
            f" coll={p['collective_bytes']:.4e} dominant={r['dominant']} "
            f"roofline_frac={r['roofline_fraction']:.3f}")
    ref = rec.get("jax_reference")
    if ref:
        line += (f"\n  jax: args={ref['argument_bytes']} "
                 f"temp={ref['temp_bytes']} flops={ref['flops']:.4e} "
                 f"coll={ref['collective_bytes']:.4e}")
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--causal-mode", default="masked_full")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    # DTensor warns on every chained redistribution; the counts hold them
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    archs = ALL_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else \
        [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                fname = out_dir / f"{args.tag}_{arch}_{shape}_{mesh_kind}.json"
                if fname.exists():
                    print(f"[dryrun] SKIP(existing) {fname.name}", flush=True)
                    continue
                print(f"[dryrun] {arch} x {shape} x {mesh_kind} ...",
                      flush=True)
                try:
                    rec = run_cell(arch, shape, mesh_kind,
                                   causal_mode=args.causal_mode,
                                   out_dir=out_dir, tag=args.tag)
                except Exception as e:  # noqa: BLE001
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "tag": args.tag, "status": "error",
                           "error": repr(e),
                           "traceback": traceback.format_exc()[-3000:]}
                fname.write_text(json.dumps(rec, indent=1))
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_fail += st == "error"
                if st == "ok":
                    print(describe(rec), flush=True)
                else:
                    print(f"  {st}: {rec.get('reason', rec.get('error'))}"
                          [:300], flush=True)
    print(f"[dryrun] done ok={n_ok} skipped={n_skip} failed={n_fail}",
          flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
