"""Training driver: a registered architecture (or a ModelConfig), the
synthetic token stream, AdamW + cosine, checkpoint/resume and per-step
stats, on the card unless ``device="cpu"``. ``--preset smoke`` trains the
reduced config; ``--preset full`` the published widths.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch h2o-danube-3-4b --steps 20 --preset smoke --device cpu

Checkpoints keep the JAX package's layout: ``step_%07d.npz`` holding
``a{i}``, the leaves of ``{"params": ..., "opt": ...}`` in JAX's flatten
order (dict keys sorted, lists in order: the moments, the step, then the
parameters), beside ``meta.json`` (step and data-stream state) and
``LATEST``. A float32 checkpoint written by either package resumes in
the other. A bfloat16 leaf is stored as its 16 bits in a 2-byte void
array (``|V2``), the bytes ``np.savez`` writes for the JAX package's
bfloat16 arrays, since numpy has no bfloat16 of its own.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Union

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, TokenStream
from repro_torch.models import ParamTree, init_params
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class TrainResult:
    params: ParamTree
    opt_state: dict
    hist: list          # (step, loss) at the logged steps, as the JAX driver's
    steps: list         # every step run: step, loss, aux, grad_norm, lr, wall_s
    seconds: float      # wall seconds of the step loop


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _leaf_from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a)).to(like.dtype)


def save_train_ckpt(path: Path, step: int, params, opt_state,
                    data_state: dict):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves({"params": params, "opt": opt_state})
    arrs = {f"a{i}": _leaf_to_numpy(v) for i, v in enumerate(leaves)}
    np.savez_compressed(path / f"step_{step:07d}.npz", **arrs)
    (path / "meta.json").write_text(json.dumps(
        {"step": step, "data": data_state}))
    (path / "LATEST").write_text(f"step_{step:07d}.npz")


@torch.no_grad()
def load_train_ckpt(path: Path, params, opt_state):
    """Read the latest checkpoint under ``path`` INTO ``params`` and
    ``opt_state`` (in place, each leaf cast to its dtype). Raises if the
    leaf count or a shape differs. -> (params, opt_state, meta)."""
    path = Path(path)
    latest = (path / "LATEST").read_text().strip()
    leaves = tree_leaves({"params": params, "opt": opt_state})
    with np.load(path / latest) as z:
        if len(z.files) != len(leaves):
            raise ValueError(f"{latest}: {len(z.files)} arrays, the model "
                             f"has {len(leaves)} leaves")
        for i, t in enumerate(leaves):
            a = z[f"a{i}"]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{latest} a{i}: shape {a.shape}, "
                                 f"expected {tuple(t.shape)}")
            t.copy_(_leaf_from_numpy(a, t))
    meta = json.loads((path / "meta.json").read_text())
    return params, opt_state, meta


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train(arch: Union[str, ModelConfig], *, steps: int,
          preset: str = "smoke", global_batch: int = 8, seq_len: int = 128,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          resume: bool = False, log_every: int = 10,
          causal_mode: str = "masked_full", seed: int = 0,
          device="cuda") -> TrainResult:
    """Train ``steps`` steps (from the checkpoint's step when resuming).
    ``arch`` is a registered name (cut to ``reduced()`` at the smoke
    preset) or a ModelConfig taken as it is. Weights are drawn from a
    torch.Generator seeded with ``seed`` on ``device``; the token stream
    is seeded with ``seed`` too (0, as the JAX driver's). Warm-up is
    max(steps // 20, 5) steps of the cosine schedule over ``steps``."""
    if isinstance(arch, ModelConfig):
        cfg = arch
    else:
        cfg = get_config(arch)
        if preset == "smoke":
            cfg = cfg.reduced()
    if cfg.frontend is not None:
        raise ValueError(f"{cfg.name}: train() feeds token batches only; "
                         "drive a frontend model with make_train_step")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device)
    opt = adamw_init(params)
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=seq_len,
                                    global_batch=global_batch, seed=seed))
    start = 0
    if resume and ckpt_dir and (Path(ckpt_dir) / "LATEST").exists():
        params, opt, meta = load_train_ckpt(Path(ckpt_dir), params, opt)
        stream.restore(meta["data"])
        start = meta["step"]
        print(f"[train] resumed from step {start}")
    step_fn = make_train_step(cfg, total_steps=steps,
                              warmup=max(steps // 20, 5),
                              causal_mode=causal_mode)
    hist, per_step = [], []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(start, steps):
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in stream.next_batch().items()}
        params, opt, metrics = step_fn(params, opt, batch)
        row = {k: float(v) for k, v in metrics.items()}
        _sync(device)
        row.update(step=i + 1, wall_s=time.perf_counter() - t_step)
        per_step.append(row)
        if (i + 1) % log_every == 0 or i == start:
            hist.append((i + 1, row["loss"]))
            tps = global_batch * seq_len * (i + 1 - start) / \
                max(time.perf_counter() - t0, 1e-9)
            print(f"[train] step {i+1}/{steps} loss={row['loss']:.4f} "
                  f"gnorm={row['grad_norm']:.3f} tok/s={tps:,.0f}",
                  flush=True)
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            save_train_ckpt(Path(ckpt_dir), i + 1, params, opt,
                            stream.state())
    return TrainResult(params=params, opt_state=opt, hist=hist,
                       steps=per_step, seconds=time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-3-4b", choices=ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--causal-mode", default="masked_full")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to train on the CPU")
    res = train(args.arch, steps=args.steps, preset=args.preset,
                global_batch=args.global_batch, seq_len=args.seq_len,
                ckpt_dir=args.ckpt_dir, resume=args.resume,
                causal_mode=args.causal_mode, seed=args.seed,
                device=args.device)
    first, last = res.hist[0][1], res.hist[-1][1]
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return res


if __name__ == "__main__":
    main()
