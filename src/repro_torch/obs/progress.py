"""Human-readable per-superstep progress lines — the port's copy of
``repro.obs.progress``.

The paper's Section 5.7 statistics collector names two consumers: the
runtime (plan selection) and the *user* (job progress). The planner has
its feed; this module serves the user one — ``pregel_run --progress``
prints one line per superstep built from the same ``SuperstepStats``
records, e.g.::

    superstep   7  active 12.4k (19.0%)  msgs 48.2k  wall 0.031s  hit 0.97  stall 2.1ms  plan left_outer/sort/delta

Fields that a given execution mode does not measure (cache hit rate on
the in-memory path, stall on the barrier path) are simply omitted.
"""
from __future__ import annotations

from typing import Optional


def _si(n: float) -> str:
    n = float(n)
    for div, suf in ((1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(n) >= div:
            return f"{n / div:.1f}{suf}"
    return f"{int(n)}" if float(n).is_integer() else f"{n:.1f}"


def fmt_plan(plan) -> str:
    """Compact ``join/groupby/storage`` plan tag for the progress line."""
    if plan is None:
        return ""
    parts = []
    for attr in ("join", "groupby", "connector", "storage"):
        v = getattr(plan, attr, None)
        if v:
            parts.append(str(v))
    return "/".join(parts)


def progress_line(rec: dict, plan=None, *,
                  n_vertices: Optional[int] = None) -> str:
    """One progress line from a ``SuperstepStats`` dict (``rec`` is what
    ``StatsCollector.dicts()`` / the ``on_superstep`` callback yields)."""
    active = rec.get("active", 0)
    out = [f"superstep {rec.get('superstep', 0):>3}",
           f"active {_si(active)}"]
    dens = rec.get("frontier_density")
    if dens is None and n_vertices:
        dens = active / n_vertices
    if dens is not None:
        out[-1] += f" ({100.0 * dens:.1f}%)"
    out.append(f"msgs {_si(rec.get('messages', 0))}")
    out.append(f"wall {rec.get('wall_s', 0.0):.3f}s")
    hit = rec.get("cache_hit_rate")
    if hit is not None:
        out.append(f"hit {hit:.2f}")
    stall = rec.get("readiness_stall_s")
    if stall is not None:
        out.append(f"stall {1e3 * stall:.1f}ms")
    depth = rec.get("readahead_depth")
    if depth is not None:
        out.append(f"ra {int(depth)}")
    xstall = rec.get("exchange_stall_s")
    if xstall is not None:
        out.append(f"xstall {1e3 * xstall:.1f}ms")
    xbytes = rec.get("exchange_bytes")
    if xbytes is not None:
        out.append(f"xbytes {_si(xbytes)}")
    tag = fmt_plan(plan)
    if tag:
        out.append(f"plan {tag}")
    if rec.get("recompiled"):
        out.append("[recompile]")
    if rec.get("event"):
        out.append(f"[{rec['event']}]")
    return "  ".join(out)
