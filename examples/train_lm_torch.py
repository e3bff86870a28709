"""End-to-end LM training on the PyTorch port: trains a reduced
h2o-danube-3-4b config on the synthetic token stream and checks that
the loss drops, as ``train_lm.py`` does on JAX. ``--arch``/``--steps``
select other architectures. Runs on the card unless ``--device cpu`` is
given:

    PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]

(A published width: python -m repro_torch.launch.train --arch <id>
--preset full.)
"""
import argparse

import torch

from repro_torch.launch.train import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run on the CPU")
    res = train(args.arch, steps=args.steps, preset="smoke",
                global_batch=args.global_batch, seq_len=args.seq_len,
                log_every=20, device=args.device)
    first, last = res.hist[0][1], res.hist[-1][1]
    assert last < first, f"loss did not improve: {first} -> {last}"
    print(f"OK: loss improved {first:.4f} -> {last:.4f} over "
          f"{args.steps} steps")
    return {"first": first, "last": last, "result": res}


if __name__ == "__main__":
    main()
