"""The control of a cell's comparison, at the cell's own size on the card:
the algorithm's ``control`` (the plain reference in the precision below
the configuration's, or with one of its guarantees broken) put in the
program's place for the jobs a run would judge, and held to the same
comparison and limits. Each seed has to come out not correct.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed. The benchmark's own runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(workload: str, seed: int, device="cuda",
                     overrides: dict | None = None,
                     cell: dict | None = None) -> dict:
    """The control's numbers for the jobs a run of ``workload`` with
    ``seed`` would judge first (jobs 1 .. compare_jobs), worst over them,
    with the limits and whether the control came out correct."""
    import torch

    from bench import graphs, jobs as jobgen, manifest as mf
    cell = cell or mf.cell(mf.load(), workload)
    cfg = {**mf.config(cell["config"]), **(overrides or {})}
    traffic = mf.traffic(cell["traffic"])
    alg = mf.algorithm(traffic["algorithm"])
    g = graphs.make_graph(cfg, seed, torch.device(device))
    stream = jobgen.JobStream(traffic, g.edges, g.n, seed)
    n = g.n
    edges = graphs.to_int64(g.edges.cpu(), device)   # as the harness's
    del g
    limits = traffic["limits"]
    worst = {}
    for i in range(1, int(traffic["compare_jobs"]) + 1):
        args = stream.job(i)
        got = alg.control(edges, n, args)
        nums = alg.compare(got, alg.reference(edges, n, args))
        for k, v in nums.items():
            worst[k] = v if k not in worst else max(worst[k], v)
    return {"workload": workload, "seed": seed,
            "checks": {k: {"value": worst[k], "limit": limits[k]}
                       for k in limits},
            "correct": all(worst[k] <= limits[k] for k in limits)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("[control] needs a CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds:
        print(json.dumps(control_readings(args.workload, s)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main())
