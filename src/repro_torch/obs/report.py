"""Schema-validated run reports: the audit trail as a CI artifact — the
port's copy of ``repro.obs.report`` (the same schema, so either package
validates and compares the other's reports).

``build_report`` assembles one ``pregelix-run-report/v1`` document from
the three observability streams of a single run — the per-superstep
stats records (``RunResult.stats``), the plan-audit ledger
(:mod:`repro_torch.obs.explain`) and the tier-occupancy ledger
(:mod:`repro_torch.obs.memwatch`) — joined by superstep number. No leg is
re-timed: the report is a pure join over what the run already measured.

Document shape::

    {"schema": "pregelix-run-report/v1",
     "meta": {...free-form run identity...},
     "supersteps": [{"superstep": 0, "wall_s": ..., "active": ...,
                     "audit": {predicted/legs/drift_score}|absent,
                     "memory": {hbm/dram/ssd}|absent,
                     "extra": {...stats extras...}}, ...],
     "decisions": [{"superstep", "kind": replan|recalibrate, ...}],
     "faults": {recovery/stragglers/io/injected}|absent,
     "memory_peaks": {...memwatch watermarks...},
     "summary": {"supersteps", "wall_s", "mean_drift", "max_drift",
                 "replans", "recalibrations"}}

``validate_report`` collects EVERY violation (CI logs show all problems
in one run); ``compare`` diffs two reports and flags drift / occupancy
regressions with deliberately lenient default thresholds — two runs of
the same workload must compare clean despite scheduler noise.

CLI::

    python -m repro_torch.obs.report --validate A.json [B.json ...]
    python -m repro_torch.obs.report --compare BASE.json OTHER.json [--strict]
"""
from __future__ import annotations

import json
import math
from typing import List, Optional

SCHEMA = "pregelix-run-report/v1"

DECISION_KINDS = ("replan", "recalibrate")

# stats-extra keys promoted to top-level superstep-row fields
_ROW_FIELDS = ("active", "messages", "wall_s", "recompiled",
               "frontier_density", "bytes_exchanged")


# ---- assembly --------------------------------------------------------

def build_report(*, stats: Optional[list] = None, explain=None,
                 memwatch=None, meta: Optional[dict] = None,
                 recovery: Optional[list] = None) -> dict:
    """Join the run's observability streams into one document.

    ``stats`` is ``RunResult.stats`` (dict records; event records feed
    the decision log context but not the rows), ``explain`` an
    ``ExplainLedger`` (or its ``as_dict()``), ``memwatch`` a ``MemWatch``
    (or its ``as_dict()``), ``recovery`` a ``RunResult.recovery`` list
    (the failure manager's supervisor events). A ``faults`` section is
    emitted whenever the run saw recovery events, straggler flags, I/O
    retries/errors, or an active fault injector."""
    exd = explain.as_dict() if hasattr(explain, "as_dict") else \
        (explain or {})
    mwd = memwatch.as_dict() if hasattr(memwatch, "as_dict") else \
        (memwatch or {})
    audit_by_ss = {r["superstep"]: r for r in exd.get("supersteps", ())
                   if "superstep" in r}
    mem_by_ss = {s["superstep"]: s for s in mwd.get("samples", ())
                 if "superstep" in s}
    rows = []
    for rec in (stats or ()):
        if rec.get("event") is not None:
            continue
        i = rec["superstep"]
        row = {"superstep": int(i)}
        extra = {}
        for k, v in rec.items():
            if k == "superstep":
                continue
            (row if k in _ROW_FIELDS else extra)[k] = v
        if extra:
            row["extra"] = extra
        if i in audit_by_ss:
            audit = {k: v for k, v in audit_by_ss[i].items()
                     if k != "superstep"}
            row["audit"] = audit
        if i in mem_by_ss:
            row["memory"] = {k: v for k, v in mem_by_ss[i].items()
                            if k != "superstep"}
        rows.append(row)
    drifts = [r["audit"]["drift_score"] for r in rows
              if "audit" in r and "drift_score" in r["audit"]]
    decisions = list(exd.get("decisions", ()))
    summary = {
        "supersteps": len(rows),
        "wall_s": float(sum(r.get("wall_s", 0.0) for r in rows)),
        "mean_drift": (sum(drifts) / len(drifts)) if drifts else None,
        "max_drift": max(drifts) if drifts else None,
        "replans": sum(1 for d in decisions if d.get("kind") == "replan"),
        "recalibrations": sum(1 for d in decisions
                              if d.get("kind") == "recalibrate"),
    }
    report = {"schema": SCHEMA, "meta": dict(meta or {}),
              "supersteps": rows, "decisions": decisions,
              "memory_peaks": dict(mwd.get("peaks", {})),
              "summary": summary}
    faults_sec = _faults_section(rows, recovery)
    if faults_sec:
        report["faults"] = faults_sec
    if "memory_budget_bytes" in mwd:
        report["meta"].setdefault("memory_budget_bytes",
                                  mwd["memory_budget_bytes"])
    return report


def _faults_section(rows, recovery) -> dict:
    """The "Faults & recovery" stream: supervisor recovery events,
    straggler flags, the I/O retry/error/degradation counters summed
    over the rows' per-superstep metrics, and the fault injector's
    summary when a chaos plan is active."""
    sec: dict = {}
    if recovery:
        sec["recovery"] = list(recovery)
    stragglers = [r["extra"]["straggler"] for r in rows
                  if "straggler" in r.get("extra", {})]
    if stragglers:
        sec["stragglers"] = stragglers
    retries = errors = 0
    degrade_peak = 0
    seen_io = False
    for r in rows:
        m = r.get("extra", {}).get("metrics", {})
        e = r.get("extra", {})
        for src in (m, e):
            if any(k in src for k in ("io.retries", "io_retries",
                                      "io_errors", "io.errors")):
                seen_io = True
        retries += int(m.get("io.retries", e.get("io_retries", 0)) or 0)
        errors += int(m.get("io.errors", e.get("io_errors", 0)) or 0)
        degrade_peak = max(degrade_peak,
                           int(m.get("io.degrade_level",
                                     e.get("io_degrade_level", 0)) or 0))
    if seen_io and (retries or errors or degrade_peak):
        sec["io"] = {"retries": retries, "errors": errors,
                     "degrade_level_peak": degrade_peak}
    from repro_torch.runtime import faults as _chaos
    if _chaos.enabled():
        sec["injected"] = _chaos.summary()
    return sec


def to_markdown(report: dict) -> str:
    """Human-readable digest: summary, per-superstep drift table, and
    the decision log."""
    out = [f"# Run report ({report.get('schema', '?')})", ""]
    meta = report.get("meta", {})
    if meta:
        out.append("| meta | value |")
        out.append("|---|---|")
        for k in sorted(meta):
            out.append(f"| {k} | {meta[k]} |")
        out.append("")
    s = report.get("summary", {})
    md = s.get("mean_drift")
    line = (f"**{s.get('supersteps', 0)} supersteps**, "
            f"wall {s.get('wall_s', 0.0):.3f}s, ")
    if md is not None:
        line += f"mean drift {md:.3f}, "
    line += (f"{s.get('replans', 0)} replan(s), "
             f"{s.get('recalibrations', 0)} recalibration(s)")
    out += [line, ""]
    out.append("| superstep | plan | wall s | predicted s | drift "
               "| dram occupancy |")
    out.append("|---|---|---|---|---|---|")
    for r in report.get("supersteps", ()):
        a = r.get("audit", {})
        occ = r.get("memory", {}).get("dram", {}).get("occupancy")
        out.append("| {} | {} | {:.4f} | {} | {} | {} |".format(
            r.get("superstep"), a.get("plan", "-"),
            r.get("wall_s", 0.0),
            f"{a['predicted_total_s']:.4f}"
            if "predicted_total_s" in a else "-",
            f"{a['drift_score']:.3f}" if "drift_score" in a else "-",
            f"{occ:.0%}" if occ is not None else "-"))
    decisions = report.get("decisions", ())
    if decisions:
        out += ["", "## Decisions", ""]
        for d in decisions:
            line = f"- superstep {d.get('superstep')}: {d.get('kind')}"
            if d.get("kind") == "replan":
                line += (f" {d.get('from', '?')} -> {d.get('to', '?')} "
                         f"({len(d.get('candidates', ()))} candidates "
                         "priced)")
            out.append(line)
    peaks = report.get("memory_peaks", {})
    if peaks:
        out += ["", "## Memory peaks", ""]
        for k in sorted(peaks):
            out.append(f"- {k}: {peaks[k]}")
    fl = report.get("faults", {})
    if fl:
        out += ["", "## Faults & recovery", ""]
        for ev in fl.get("recovery", ()):
            out.append(
                "- recovery #{}: restored from {} onto {} worker(s), "
                "blacklist {} — {}".format(
                    ev.get("attempt"),
                    ev.get("restored_from") or "initial relations",
                    ev.get("healthy_workers"),
                    ev.get("blacklist") or "[]",
                    ev.get("error", "?")))
        io = fl.get("io")
        if io:
            out.append(f"- I/O: {io.get('retries', 0)} retried op(s), "
                       f"{io.get('errors', 0)} exhausted failure(s), "
                       f"peak degradation level "
                       f"{io.get('degrade_level_peak', 0)}")
        for s in fl.get("stragglers", ()):
            out.append(f"- straggler: superstep {s.get('superstep')} "
                       f"took {s.get('wall_s', 0.0):.4f}s "
                       f"(median {s.get('median_s', 0.0):.4f}s)")
        inj = fl.get("injected")
        if inj:
            fired = sum(sp.get("fired", 0) for sp in inj.get("specs", ()))
            out.append(f"- fault injector ACTIVE (seed "
                       f"{inj.get('seed')}): {fired} fault(s) fired "
                       f"across {len(inj.get('specs', ()))} spec(s)")
    return "\n".join(out) + "\n"


def write_report(path: str, report: dict, *,
                 markdown: Optional[str] = None) -> dict:
    """Write the JSON document (and optionally a markdown digest)."""
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
    if markdown:
        with open(markdown, "w") as f:
            f.write(to_markdown(report))
    return report.get("summary", {})


# ---- validation ------------------------------------------------------

def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) \
        and math.isfinite(x)


def validate_report(obj) -> List[str]:
    """Schema-check a report document; returns the FULL list of
    violations (empty = valid). Never raises on malformed input."""
    errs: List[str] = []
    if not isinstance(obj, dict):
        return ["top level must be a dict"]
    if obj.get("schema") != SCHEMA:
        errs.append(f"schema must be {SCHEMA!r}, got "
                    f"{obj.get('schema')!r}")
    if not isinstance(obj.get("meta"), dict):
        errs.append("meta must be a dict")
    rows = obj.get("supersteps")
    if not isinstance(rows, list) or not rows:
        errs.append("supersteps must be a non-empty list")
        rows = []
    budget = obj.get("meta", {}).get("memory_budget_bytes") \
        if isinstance(obj.get("meta"), dict) else None
    for n, r in enumerate(rows):
        where = f"supersteps[{n}]"
        if not isinstance(r, dict):
            errs.append(f"{where} is not an object")
            continue
        if not isinstance(r.get("superstep"), int) \
                or r["superstep"] < 0:
            errs.append(f"{where} bad superstep")
        if not _num(r.get("wall_s", 0.0)) or r.get("wall_s", 0.0) < 0:
            errs.append(f"{where} bad wall_s")
        a = r.get("audit")
        if a is not None:
            if not isinstance(a, dict):
                errs.append(f"{where}.audit is not an object")
            elif "error" not in a:
                if not _num(a.get("drift_score")):
                    errs.append(f"{where}.audit drift_score must be a "
                                "finite number")
                legs = a.get("legs")
                if not isinstance(legs, dict):
                    errs.append(f"{where}.audit.legs must be a dict")
                else:
                    for leg, v in legs.items():
                        for k in ("predicted_s", "measured_s", "drift"):
                            if not _num(v.get(k)):
                                errs.append(f"{where}.audit.legs."
                                            f"{leg}.{k} must be a "
                                            "finite number")
                if not isinstance(a.get("predicted"), dict) \
                        or not a.get("predicted"):
                    errs.append(f"{where}.audit.predicted must be a "
                                "non-empty per-term dict")
        m = r.get("memory")
        if m is not None:
            dram = m.get("dram")
            if dram is not None:
                for k in ("resident_bytes", "dirty_bytes",
                          "pinned_bytes"):
                    if not _num(dram.get(k)) or dram.get(k) < 0:
                        errs.append(f"{where}.memory.dram.{k} must be "
                                    "a non-negative number")
                b = dram.get("budget_bytes") or budget
                if b and _num(dram.get("peak_resident_bytes", 0)) \
                        and dram.get("peak_resident_bytes", 0) > b:
                    errs.append(f"{where}.memory.dram peak "
                                f"{dram['peak_resident_bytes']} exceeds "
                                f"budget {b}")
            hbm = m.get("hbm")
            if hbm is not None and not _num(hbm.get("total_bytes")):
                errs.append(f"{where}.memory.hbm.total_bytes must be "
                            "a number")
    decisions = obj.get("decisions")
    if not isinstance(decisions, list):
        errs.append("decisions must be a list")
        decisions = []
    for n, d in enumerate(decisions):
        where = f"decisions[{n}]"
        if not isinstance(d, dict):
            errs.append(f"{where} is not an object")
            continue
        if d.get("kind") not in DECISION_KINDS:
            errs.append(f"{where} unknown kind {d.get('kind')!r}")
        if not isinstance(d.get("superstep"), int):
            errs.append(f"{where} missing superstep")
        if d.get("kind") == "replan":
            cands = d.get("candidates")
            if not isinstance(cands, list) or not cands:
                errs.append(f"{where} replan must carry a non-empty "
                            "candidate price table")
            else:
                for c in cands:
                    if not isinstance(c, dict) or "plan" not in c \
                            or not _num(c.get("seconds")):
                        errs.append(f"{where} bad candidate entry {c!r}")
                        break
    if not isinstance(obj.get("summary"), dict):
        errs.append("summary must be a dict")
    fl = obj.get("faults")
    if fl is not None:
        if not isinstance(fl, dict):
            errs.append("faults must be a dict")
        else:
            for key in ("recovery", "stragglers"):
                if key in fl and not isinstance(fl[key], list):
                    errs.append(f"faults.{key} must be a list")
            if "io" in fl and not isinstance(fl["io"], dict):
                errs.append("faults.io must be a dict")
    return errs


# ---- comparison ------------------------------------------------------

def compare(base: dict, other: dict, *, drift_tol: float = 1.5,
            occupancy_tol: float = 0.2) -> dict:
    """Diff two reports; flag drift / occupancy regressions in ``other``
    relative to ``base``.

    Thresholds are deliberately lenient — drift is a log-ratio, so
    ``drift_tol=1.5`` flags only a ~4.5x worsening of the
    prediction/measurement ratio, and occupancy must rise by 20
    percentage points — two runs of the same workload must compare
    clean despite scheduler and cache noise."""
    regressions = []
    bs, os_ = base.get("summary", {}), other.get("summary", {})
    bd, od = bs.get("mean_drift"), os_.get("mean_drift")
    if bd is not None and od is not None and od - bd > drift_tol:
        regressions.append({
            "kind": "drift", "metric": "mean_drift",
            "base": bd, "other": od,
            "detail": f"mean drift rose {bd:.3f} -> {od:.3f} "
                      f"(tol {drift_tol})"})
    bp = base.get("memory_peaks", {})
    op = other.get("memory_peaks", {})
    bo, oo = bp.get("dram_occupancy"), op.get("dram_occupancy")
    if bo is not None and oo is not None and oo - bo > occupancy_tol:
        regressions.append({
            "kind": "occupancy", "metric": "dram_occupancy",
            "base": bo, "other": oo,
            "detail": f"peak DRAM occupancy rose {bo:.0%} -> {oo:.0%} "
                      f"(tol {occupancy_tol:.0%})"})
    return {
        "ok": not regressions,
        "regressions": regressions,
        "base": {"supersteps": bs.get("supersteps"),
                 "wall_s": bs.get("wall_s"), "mean_drift": bd,
                 "dram_occupancy": bo},
        "other": {"supersteps": os_.get("supersteps"),
                  "wall_s": os_.get("wall_s"), "mean_drift": od,
                  "dram_occupancy": oo},
    }


# ---- CLI -------------------------------------------------------------

def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Validate or compare pregelix run reports.")
    ap.add_argument("--validate", nargs="+", metavar="PATH",
                    help="schema-check report file(s); lists EVERY "
                         "violation and exits nonzero on any")
    ap.add_argument("--compare", nargs=2, metavar=("BASE", "OTHER"),
                    help="diff two reports and print regressions")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero when --compare finds regressions")
    args = ap.parse_args(argv)
    if not args.validate and not args.compare:
        ap.error("one of --validate / --compare is required")
    rc = 0
    for path in (args.validate or ()):
        try:
            errs = validate_report(_load(path))
        except (OSError, ValueError) as e:
            errs = [f"unreadable: {e}"]
        if errs:
            rc = 1
            print(f"INVALID {path}: {len(errs)} violation(s)")
            for e in errs:
                print(f"  - {e}")
        else:
            obj = _load(path)
            s = obj.get("summary", {})
            print(f"OK {path}: {s.get('supersteps')} supersteps, "
                  f"{s.get('replans', 0)} replan(s), mean drift "
                  f"{s.get('mean_drift')}")
    if args.compare:
        base, other = (_load(p) for p in args.compare)
        diff = compare(base, other)
        print(json.dumps(diff, indent=1))
        if args.strict and not diff["ok"]:
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
