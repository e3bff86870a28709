"""The benchmark's command:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cell's cards. It
prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last: each number compared with its limit), and the same
checks as the last lines of standard error. ``device.count`` is the
cell's ``chips``; on several chips ``device.memory_peak_bytes`` is the
fullest card's peak (on the first card the harness's and rank 0's
summed), ``device.peak_bytes_by_rank`` each rank's over the window, and
a ``--trace 1`` run's ``busy_s``, ``window_s`` and ``breakdown`` the
ranks' means.
Without CUDA, with fewer cards than the cell asks for, or with a JAX
module loaded once the window has closed, in this process or in a rank
of a cell on several chips, it exits non-zero and prints no result. The
ranks are processes of the port's ``RankPool``, stopped before the result
is printed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def setup_process():
    """The checkout's root and its src/ on the path, never this directory
    (a file here must not shadow a module of the standard library), and
    the caches of compilers the port may reach inside the checkout at
    fixed paths (the CUDA kernels build into build/repro_torch_kernels)."""
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))


# top-level module names no run may load
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules(names) -> list:
    """The loaded modules whose top-level name is banned, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in names if m.split(".")[0] in BANNED})


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    import repro_torch  # noqa: F401  (the port under test: no run without it)
    from bench import harness, manifest
    chips = int(manifest.cell(manifest.load(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", t_start=T_START)
    found = banned_modules(sys.modules)
    in_ranks = out.pop("banned_in_ranks", [])
    if found or in_ranks:
        print(f"[bench] modules that no run may load are loaded: {found} "
              f"in this process, {in_ranks} in the ranks", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    setup_process()
    sys.exit(main())
