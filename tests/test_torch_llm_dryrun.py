"""The port's LLM production dry run (``launch/dryrun.py``,
``launch/specs.py``, ``models/sharded.py``) against the JAX package's,
on the CPU with no device: rank 0 of a mesh over c10d's ``fake`` process
group, on meta DTensors, under ``launch/op_cost``'s counter.

1. Placements: for all 10 archs at full size and profiles "tp" and
   "zero", the port's ``model_specs`` tree has the JAX tree's paths, and
   each leaf the same shape and a placement equal to the JAX
   PartitionSpec (both padded with None to one entry a dimension).
   Specs only, no arrays. Exact.
2. Argument bytes: for every runnable (arch, shape, mesh) of the 10
   archs, the bytes of rank 0's shards of ``specs.cell_inputs`` equal the
   JAX ``cell_inputs`` over an ``AbstractMesh`` of the same shape, summed
   as ``x.sharding.shard_shape(x.shape)`` x itemsize. Exact (int8 caches,
   bf16 moments and SSM states included).
3. Counts that catch a wrong partition, at ``reduced()`` size (a
   full-size count takes too long here): the three new archs and
   qwen2-moe on a (2, 2) mesh at batch 4 of 32, prefill, decode and a
   train step. Rank 0's matmul flops x 4 lie in [0.95, 2.2] x the same
   counter's for the unsharded step at the cell's global shapes (a
   count of the global shapes reads 4 and fails); collective bytes are
   > 0; a train step's all-reduce and reduce-scatter bytes cover its
   gradients (each parameter is replicated over "data": at least its
   local bytes). The scaled count equals the full one.
4. The JAX figures of ``dryrun.JAX_REFERENCE`` (the 18 cells of the last
   three configs) are printed beside the port's, not gated against them
   (GSPMD's partition is not DTensor's). One is recomputed live in a
   subprocess, as its comment in ``launch/dryrun.py`` shows:
   stablelm-12b decode_32k on the (16, 16) mesh with Auto axes
   (``repro.launch.dryrun.run_cell``'s own mesh raises
   ShardingTypeError on jax 0.9.0: its axes are Explicit).
5. DTensor plumbing: a reduced prefill, decode and train step on a
   (2, 1, 2) mesh too; FSDP's all-gathers and gradient reduce-scatters in
   a train step; and on real CPU DTensors (gloo, 4 spawned ranks) the
   reduced prefill returns the unsharded port's logits within 1e-5, and
   a reduced llama4 train step its loss, grad norm and updates.
6. The CLI: ``--arch ... --shape ... --mesh single`` writes the
   reference's record keys plus ``matmul_flops`` and ``counted``, skips
   an existing file and records a skipped cell.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import copy
import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch.specs import cell_inputs as j_cell_inputs
from repro.models.model import model_specs as j_model_specs
from repro.models.param import Spec as JSpec
from repro_torch.configs import (ALL_ARCHS, SHAPES, get_config,
                                 runnable_cells)
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun, op_cost, specs
from repro_torch.launch.mesh import device_mesh, fake_group
from repro_torch.models import (init_caches, make_decode_step,
                                make_prefill_step, make_train_step)
from repro_torch.models.model import model_specs
from repro_torch.models.param import (DTYPES, ParamTree, full_placement,
                                      is_spec, tree_map_specs)
from repro_torch.optim import adamw_init

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)


# ---------------------------------------------------------------- 1


def _flat_port(tree, path=()):
    if is_spec(tree):
        return {path: tree}
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        out.update(_flat_port(v, path + (k,)))
    return out


def _flat_jax(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JSpec))[0]
    return {tuple(getattr(e, "key", getattr(e, "idx", None)) for e in p): s
            for p, s in leaves}


@pytest.mark.parametrize("profile", ["tp", "zero"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_placements_match_jax(arch, profile):
    port = _flat_port(model_specs(get_config(arch), profile))
    ref = _flat_jax(j_model_specs(j_get_config(arch), profile))
    assert set(port) == set(ref)
    for path, s in port.items():
        j = ref[path]
        assert tuple(s.shape) == tuple(j.shape), path
        want = list(j.pspec) + [None] * (len(j.shape) - len(j.pspec))
        assert full_placement(s) == want, (path, s.placement, j.pspec)


# ---------------------------------------------------------------- 2


def _jax_argument_bytes(arch: str, shape: str, mesh_kind: str) -> int:
    dims, names = MESHES[mesh_kind]
    mesh = jax.sharding.AbstractMesh(dims, names)
    _, args = j_cell_inputs(j_get_config(arch), SHAPES[shape], mesh)
    return sum(int(np.prod(x.sharding.shard_shape(x.shape)))
               * x.dtype.itemsize for x in jax.tree.leaves(args))


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_argument_bytes_match_jax(arch, mesh_kind):
    cfg = get_config(arch)
    dims, names = MESHES[mesh_kind]
    shapes = [s for s, why in runnable_cells(cfg).items() if why is None]
    with fake_group(int(np.prod(dims))):
        mesh = device_mesh(dims, names)
        got = {s: op_cost.nbytes(specs.cell_inputs(cfg, SHAPES[s], mesh)[1])
               for s in shapes}
    want = {s: _jax_argument_bytes(arch, s, mesh_kind) for s in shapes}
    assert got == want


# ---------------------------------------------------------------- 3

COUNT_ARCHS = ("stablelm-12b", "yi-34b", "llama4-maverick-400b-a17b",
               "qwen2-moe-a2.7b")
B4, S32 = 4, 32


def _meta_params(cfg):
    dt = DTYPES[cfg.dtype]
    return ParamTree(tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype or dt, device="meta"),
        model_specs(cfg)))


def _unsharded(cfg, kind: str) -> op_cost.Cost:
    """The counter's figures of the single-device step at the cell's
    global shapes, on meta tensors."""
    params = _meta_params(cfg)
    tok = torch.empty((B4, S32), dtype=torch.int32, device="meta")
    if kind == "prefill":
        return op_cost.measure(make_prefill_step(cfg), params,
                               {"tokens": tok})
    if kind == "decode":
        caches = init_caches(cfg, B4, S32, device="meta")
        return op_cost.measure(make_decode_step(cfg), params, tok[:, :1],
                               caches, S32 - 1)
    return op_cost.measure(make_train_step(cfg), params, adamw_init(params),
                           {"tokens": tok, "labels": tok})


def _sharded(cfg, kind: str, counted="full", batch=B4, seq=S32):
    with fake_group(4):
        mesh = device_mesh((2, 2), ("data", "model"))
        return dryrun.count_cell(cfg, ShapeCell("t", seq, batch, kind),
                                 mesh, counted=counted)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", COUNT_ARCHS)
def test_rank0_counts_a_quarter_of_the_step(arch, kind):
    cfg = get_config(arch).reduced()
    whole = _unsharded(cfg, kind).matmul_flops
    _, _, f, note = _sharded(cfg, kind)
    assert note == "full"
    ratio = 4 * f["matmul_flops"] / whole
    assert 0.95 <= ratio <= 2.2, ratio
    assert f["coll_bytes"] > 0
    if kind == "train":
        reduced = f.get("coll:all-reduce", 0) + f.get("coll:reduce-scatter",
                                                      0)
        with fake_group(4):
            params = specs.sharded_params(cfg, device_mesh(
                (2, 2), ("data", "model")), "tp")
            assert reduced >= op_cost.nbytes(params)


def test_scaled_count_equals_the_full_count(monkeypatch):
    """The 4-layer stack at 1 and 2 layers and 2 and 3 microbatches,
    extrapolated to 4 layers and 4 microbatches (16 rows, 8 a rank), as
    the full count (the temp peak aside: an estimate)."""
    monkeypatch.setitem(specs.TRAIN_MICROBATCHES, "stablelm-12b", 4)
    cfg = dataclasses.replace(get_config("stablelm-12b").reduced(),
                              name="stablelm-12b")
    full = _sharded(cfg, "train", batch=16, seq=16)[2]
    scaled = _sharded(cfg, "train", counted="scaled", batch=16, seq=16)
    assert scaled[3].startswith("scaled: the first stage's period at 1 "
                                "and 2 of its 4 repeats, 2 and 3 of 4")
    for k in ("matmul_flops", "flops", "bytes", "coll_bytes"):
        assert scaled[2][k] == pytest.approx(full[k], rel=1e-9), k


# ---------------------------------------------------------------- 4

LIVE = """
import json, os, sys
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import SHAPES, get_config
from repro.launch import hlo_cost
from repro.launch.specs import cell_inputs, step_fn_for
mesh = jax.make_mesh((16, 16), ("data", "model"),
                     devices=jax.devices()[:256],
                     axis_types=(AxisType.Auto,) * 2)
cfg = get_config("stablelm-12b")
with mesh:
    kind, args = cell_inputs(cfg, SHAPES["decode_32k"], mesh)
    c = jax.jit(step_fn_for(cfg, kind, mesh)).lower(*args).compile()
    cost = hlo_cost.analyze(c.as_text())
m = c.memory_analysis()
print(json.dumps([m.argument_size_in_bytes, m.temp_size_in_bytes,
                  cost.flops, cost.coll_bytes]))
"""


def test_jax_reference_constant_reproduces_live():
    assert len(dryrun.JAX_REFERENCE) == 18
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=256",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", LIVE], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = dryrun.JAX_REFERENCE[("stablelm-12b", "decode_32k", "single")]
    assert got[:2] == list(want[:2])
    assert got[2:] == pytest.approx(list(want[2:]), rel=1e-9)


# ---------------------------------------------------------------- 5


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_a_three_dimensional_mesh(kind):
    """The step on a (2, 1, 2) (pod, data, model) mesh itself (the dry
    run counts the multi mesh with pod and data merged), 2 layers."""
    cfg = dataclasses.replace(get_config("stablelm-12b").reduced(),
                              num_layers=2)
    with fake_group(4):
        mesh = device_mesh((2, 1, 2), ("pod", "data", "model"))
        k, args = specs.cell_inputs(cfg, ShapeCell("t", S32, B4, kind),
                                    mesh)
        f = op_cost.measure(specs.step_fn_for(cfg, k, mesh), *args)
    whole = _unsharded(cfg, kind).matmul_flops
    assert 0.95 <= 4 * f.matmul_flops / whole <= 2.2
    assert f.coll_bytes > 0


def test_fsdp_gathers_weights_and_reduce_scatters_grads(monkeypatch):
    """With the FSDP threshold at 0, each (512, 1024) MLP matrix carries
    "data" (3 leaves, each stacked over 2 layers): a train step
    all-gathers each layer's where the forward uses it and again where
    the backward replays the layer, and reduce-scatters each leaf's
    gradient."""
    from repro_torch.models import model as model_mod
    monkeypatch.setattr(model_mod, "FSDP_THRESHOLD_BYTES", 0)
    cfg = dataclasses.replace(get_config("stablelm-12b").reduced(),
                              d_model=512, d_ff=1024, num_layers=2)
    fsdp = [s for s in _flat_port(model_specs(cfg)).values()
            if "data" in full_placement(s)]
    assert len(fsdp) == 3
    with fake_group(4):
        mesh = device_mesh((2, 2), ("data", "model"))
        _, args = specs.cell_inputs(cfg, ShapeCell("t", 32, 4, "train"),
                                    mesh)
        cost = op_cost.measure(specs.step_fn_for(cfg, "train", mesh), *args)
    calls = {k.split(".")[1]: v[0] for k, v in cost.by_op.items()
             if k.startswith("_c10d_functional.")}
    assert calls.get("all_gather_into_tensor", 0) >= 2 * 2 * len(fsdp)
    assert calls.get("reduce_scatter_tensor", 0) >= len(fsdp)


def _gloo_rank(rank: int, world: int, store: str, out: str):
    """One rank of the gloo run on a (2, 2) mesh, the weights the same
    seed on every rank and placed by ``specs.distribute_params``: the
    reduced stablelm-12b's prefill, and one train step of the reduced
    llama4 (MoE, experts over "model"); rank 0 saves the gathered logits,
    loss, grad norm and updated parameters beside the unsharded port's."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.models import init_params, sharded
    from repro_torch.tree import tree_leaves
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store, world))
    try:
        mesh = device_mesh((2, 2), ("data", "model"))
        rng = np.random.default_rng(5)
        place = lambda t, pl: distribute_tensor(
            t, mesh, specs.dtensor_placements(pl, mesh))
        res = {}
        cfg = get_config("stablelm-12b").reduced()
        full = init_params(cfg, torch.Generator().manual_seed(9), "cpu")
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 32)).astype(np.int32))
        _, _, logits = sharded.make_step(cfg, "prefill", mesh)(
            specs.distribute_params(full, cfg, mesh, "tp"),
            {"tokens": place(toks, ("data", None))})
        res["logits"] = (logits.full_tensor(),
                         make_prefill_step(cfg)(full, {"tokens": toks})[2])
        cfg = get_config("llama4-maverick-400b-a17b").reduced()
        full = init_params(cfg, torch.Generator().manual_seed(10), "cpu")
        # the shards may alias the tensors they were cut from, which the
        # step updates in place: the unsharded step gets its own copy
        params = specs.distribute_params(copy.deepcopy(full), cfg, mesh,
                                         "tp")
        zeros = [torch.zeros_like(t) for t in tree_leaves(params)]
        opt = {"step": distribute_tensor(torch.zeros((), dtype=torch.int32),
                                         mesh, [Replicate()] * 2),
               "m": zeros, "v": [torch.zeros_like(t) for t in zeros]}
        toks = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]),
                 "labels": torch.from_numpy(toks[:, 1:])}
        before = [t.detach().clone() for t in tree_leaves(full)]
        params, _, m = sharded.make_step(cfg, "train", mesh)(
            params, opt, {k: place(v, ("data", None))
                          for k, v in batch.items()})
        got = [t.full_tensor().detach() - b
               for t, b in zip(tree_leaves(params), before)]
        _, _, want = make_train_step(cfg)(full, adamw_init(full), batch)
        res["train"] = ([float(m["loss"].full_tensor()),
                         float(m["grad_norm"].full_tensor())],
                        [float(want["loss"]), float(want["grad_norm"])])
        res["updates"] = [(g, w.detach() - b) for g, w, b in
                          zip(got, tree_leaves(full), before)]
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


def test_real_dtensors_match_the_unsharded_port():
    """The reduced prefill's logits within 1e-5 of the unsharded port's;
    the reduced llama4's train step: loss and grad norm within rtol 1e-5,
    each parameter's update within relative L2 1e-3 (AdamW's first step
    moves an element by about lr * sign(g): a gradient summed in another
    order moves a sign only where g is near 0)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "res.pt")
        mp.start_processes(_gloo_rank, args=(4, os.path.join(tmp, "store"),
                                             out), nprocs=4,
                           start_method="spawn")
        res = torch.load(out)
    got, want = res["logits"]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(*res["train"], rtol=1e-5)
    for i, (g, w) in enumerate(res["updates"]):
        assert float((g - w).norm()) <= 1e-3 * float(w.norm()) + 1e-12, i


# ---------------------------------------------------------------- 6

RECORD_KEYS = {"arch", "shape", "mesh", "tag", "causal_mode", "status",
               "kind", "chips", "lower_s", "compile_s", "memory",
               "per_device", "xla_cost_analysis_flops", "roofline",
               "params", "active_params"}


def test_cli_writes_the_reference_record(tmp_path, capsys):
    argv = ["--arch", "stablelm-12b", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    rec = json.loads((tmp_path / "baseline_stablelm-12b_decode_32k_single"
                      ".json").read_text())
    assert RECORD_KEYS | {"counted", "count_s"} <= set(rec)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["xla_cost_analysis_flops"] is None
    assert rec["memory"]["argument_bytes"] == dryrun.JAX_REFERENCE[
        ("stablelm-12b", "decode_32k", "single")][0]
    assert {"matmul_flops", "flops", "bytes", "collective_bytes",
            "collectives"} <= set(rec["per_device"])
    assert rec["roofline"]["bound_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s",
                                     "collective_s"))
    assert rec["machine"]["name"] == "H100_MACHINE"
    out = capsys.readouterr().out
    assert "jax: args=5795389476" in out
    assert dryrun.main(argv) == 0
    assert "SKIP(existing)" in capsys.readouterr().out
    assert dryrun.main(["--arch", "yi-34b", "--shape", "long_500k", "--out",
                        str(tmp_path)]) == 0
    skipped = json.loads((tmp_path / "baseline_yi-34b_long_500k_single"
                          ".json").read_text())
    assert skipped["status"] == "skipped" and "long_500k" in \
        skipped["reason"]
