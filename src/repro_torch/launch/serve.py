"""Serving loop: batched prefill + greedy decode loop with KV and SSM
caches, on the card unless ``device="cpu"``. ``--preset smoke`` serves a
reduced config. ``--arch``: gemma3-12b (the default, as in the JAX
package's serve loop), h2o-danube-3-4b, falcon-mamba-7b, zamba2-1.2b,
qwen2-moe-a2.7b, internvl2-76b (its vision frontend fed zero patch
embeddings, as the JAX serve loop feeds it); hubert-xlarge is
encoder-only and refused.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch zamba2-1.2b --preset smoke --device cpu

The caches hold ``prompt_len + max_new`` positions, so every generated
token's K/V lands in a slot of its own (a local layer's ring keeps the
last ``window``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Union

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import (ParamTree, init_params, make_decode_step,
                                make_prefill_step)


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray          # (batch, max_new) int32 generated ids
    prompts: torch.Tensor       # (batch, prompt_len) int32
    logits: torch.Tensor        # (batch, max_new, vocab) of each step
    prefill_s: float            # wall seconds of the prefill step
    decode_s_per_token: float   # wall seconds of a decode step
    params: ParamTree
    caches: list                # K/V after the last step (model.init_caches)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: Union[str, ModelConfig], *, preset: str = "smoke",
          batch: int = 4, prompt_len: int = 64, max_new: int = 32,
          seed: int = 0, device="cuda") -> ServeResult:
    """Serve ``batch`` random prompts: prefill, then greedy decode until
    ``max_new`` tokens per prompt. ``arch`` is a registered name or a
    ModelConfig (taken as it is, whatever the preset). Weights, then
    prompts, are drawn from a torch.Generator seeded with ``seed`` on
    ``device``."""
    if isinstance(arch, ModelConfig):
        cfg = arch
    else:
        cfg = get_config(arch)
        if preset == "smoke":
            cfg = cfg.reduced()
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode service")
    if max_new < 1:
        raise ValueError("max_new must be >= 1")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=device,
                            dtype=torch.int32)
    batch_in = {"tokens": prompts}
    if cfg.frontend == "vision":
        batch_in["patch_embeds"] = torch.zeros(
            (batch, cfg.frontend_len, cfg.d_model), dtype=torch.float32,
            device=device)
    prefill = make_prefill_step(cfg, max_len=prompt_len + max_new)
    decode = make_decode_step(cfg)
    _sync(device)
    t0 = time.perf_counter()
    tok, caches, logits = prefill(params, batch_in)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    out, step_logits = [tok], [logits]
    t0 = time.perf_counter()
    for i in range(max_new - 1):
        tok, caches, logits = decode(params, tok, caches, prompt_len + i)
        out.append(tok)
        step_logits.append(logits)
    _sync(device)
    t_decode = (time.perf_counter() - t0) / max(max_new - 1, 1)
    gen_ids = torch.cat(out, dim=1).cpu().numpy()
    print(f"[serve] {cfg.name}: batch={batch} prompt={prompt_len} "
          f"new={max_new} device={device}")
    print(f"[serve] prefill {t_prefill * 1e3:.0f}ms, decode "
          f"{t_decode * 1e3:.1f}ms/token")
    print(f"[serve] sample generation ids: {gen_ids[0][:16].tolist()}")
    return ServeResult(tokens=gen_ids, prompts=prompts,
                       logits=torch.cat(step_logits, dim=1),
                       prefill_s=t_prefill, decode_s_per_token=t_decode,
                       params=params, caches=caches)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-12b", choices=ALL_ARCHS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve(args.arch, preset=args.preset, batch=args.batch,
          prompt_len=args.prompt_len, max_new=args.max_new, seed=args.seed,
          device=args.device)


if __name__ == "__main__":
    main()
