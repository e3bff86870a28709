"""The port's training step and driver against the JAX package's on the
CPU, at ``reduced()`` size (float32).

- ``make_train_step`` on qwen2-moe-a2.7b (sort dispatch: the grouped
  matmul's plain version under autograd) for 2 steps, with 1 and with 2
  microbatches: the metrics (loss, aux, grad_norm, lr) rtol 1e-5, the
  step counter equal, and every parameter and moment leaf to relative L2
  1e-5 (float32 gradients summed in another order feed AdamW, whose
  first steps move each element by about lr * sign(g)).
- ``train()`` at the smoke preset on h2o-danube-3-4b (the JAX driver's
  default), batch 2 of 32 tokens: resuming from a step-2 checkpoint
  equals the uninterrupted 4-step run exactly (the same operations on
  the same values), and a checkpoint written by either package resumes
  in the other, to relative L2 1e-5 a leaf after the 2 steps that follow.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch

import _torch_train_common as common
from repro.launch.train import train as j_train
from repro.models import make_train_step as j_make_train_step
from repro.optim import adamw_init as j_adamw_init
from repro_torch.launch import train as t_train_mod
from repro_torch.models import (make_train_step, opt_state_from_numpy,
                                params_from_numpy)
from repro_torch.tree import tree_leaves

REL = 1e-5


def _leaves_close(got_tree, want_tree, rel=REL):
    got = tree_leaves(got_tree)
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, i
        assert common.rel_l2(g.detach().float().numpy(), w) <= rel, \
            (i, w.shape, common.rel_l2(g.detach().float().numpy(), w))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    jcfg, tcfg, jp = common.jax_weights("qwen2-moe-sort")
    kw = dict(warmup=2, total_steps=10, microbatches=microbatches)
    j_step = jax.jit(j_make_train_step(jcfg, **kw))
    t_step = make_train_step(tcfg, **kw)
    js = j_adamw_init(jp)
    tp = params_from_numpy(tcfg, jp, device="cpu")
    ts = opt_state_from_numpy(tcfg, jax.tree.map(np.asarray, js), "cpu")
    for i in range(2):
        batch = common.batch_np(jcfg, seed=10 + i)
        jp, js, jm = j_step(jp, js, batch)
        tp, ts, tm = t_step(tp, ts, common.to_torch(batch))
        for k in ("loss", "aux", "grad_norm", "lr"):
            assert tm[k].dtype == torch.float32
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=common.RTOL)
    assert ts["step"].dtype == torch.int32
    assert int(ts["step"]) == int(js["step"]) == 2
    _leaves_close(tp, jp)
    _leaves_close(ts["m"], js["m"])
    _leaves_close(ts["v"], js["v"])


def _train(pkg, ckpt_dir, steps, **kw):
    kw = dict(steps=steps, preset="smoke", global_batch=2, seq_len=32,
              ckpt_dir=str(ckpt_dir), ckpt_every=2, log_every=1, **kw)
    if pkg == "jax":
        return j_train("h2o-danube-3-4b", **kw)[0]
    return t_train_mod.train("h2o-danube-3-4b", device="cpu", **kw).params


def test_resume_equals_the_uninterrupted_run(tmp_path):
    whole = t_train_mod.train("h2o-danube-3-4b", steps=4, preset="smoke",
                              global_batch=2, seq_len=32, device="cpu",
                              log_every=1)
    assert [s["step"] for s in whole.steps] == [1, 2, 3, 4]
    assert whole.hist[-1][1] < whole.hist[0][1]
    _train("torch", tmp_path, 2)
    assert (tmp_path / "LATEST").read_text() == "step_0000002.npz"
    assert json.loads((tmp_path / "meta.json").read_text()) == {
        "step": 2, "data": {"step": 2}}
    resumed = t_train_mod.train("h2o-danube-3-4b", steps=4, preset="smoke",
                                global_batch=2, seq_len=32, device="cpu",
                                ckpt_dir=str(tmp_path), resume=True,
                                log_every=1)
    assert [s["step"] for s in resumed.steps] == [3, 4]
    assert [s["loss"] for s in resumed.steps] == \
        [s["loss"] for s in whole.steps[2:]]
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(whole.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A step-2 checkpoint from ``writer`` resumes in both packages; their
    steps 3-4 agree (each leaf relative L2 1e-5)."""
    _train(writer, tmp_path / "w", 2)
    for pkg in ("jax", "torch"):
        shutil.copytree(tmp_path / "w", tmp_path / pkg)
    jp = _train("jax", tmp_path / "jax", 4, resume=True)
    tp = _train("torch", tmp_path / "torch", 4, resume=True)
    _leaves_close(tp, jp)


def test_bfloat16_checkpoint_round_trip(tmp_path):
    """bf16 leaves go to disk as their 16 bits (a 2-byte void array, as
    np.savez writes the JAX package's bfloat16 arrays) and come back
    equal."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b").reduced(),
                              dtype="bfloat16", num_layers=1)
    p = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    s = adamw_init(p)
    t_train_mod.save_train_ckpt(tmp_path, 7, p, s, {"step": 7})
    with np.load(tmp_path / "step_0000007.npz") as z:
        kinds = {z[k].dtype.str for k in z.files}
    assert "|V2" in kinds and "<f4" in kinds
    q = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    s2 = adamw_init(q)
    _, _, meta = t_train_mod.load_train_ckpt(tmp_path, q, s2)
    assert meta == {"step": 7, "data": {"step": 7}}
    for a, b in zip(tree_leaves(p), tree_leaves(q)):
        assert a.dtype == b.dtype and torch.equal(a, b)
