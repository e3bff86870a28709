"""The port's command-line entry point (``repro_torch.launch.pregel_run``,
``--device cpu``) against the JAX package's (``repro.launch.pregel_run``,
run in this process) on webmap-tiny at ``--parts 4``: in memory with the
report, audit, trace and metrics on; SSSP under ``--auto-plan``; CC out
of core on the disk tier; SSSP under ``--recover`` with a fault plan in
``REPRO_FAULT_PLAN``. Each pair gives the same superstep count, the same
final plan and switch supersteps, equal SSSP and CC values and PageRank
within rtol 1e-5, and prints a schema-valid report. ``--devices`` and
``--mesh host`` parse into the sharded driver (run in
``tests/test_torch_sharded.py``); ``--dryrun`` writes its record with no
device (``tests/test_torch_dryrun.py``), and ``--mesh production``
outside a 256-rank world stops with an error that names the count."""
import _torch_threads  # noqa: F401  (first: see the module)
import json
import re
import sys

import numpy as np
import pytest

import repro.core
import repro.launch.pregel_run as jcli
import repro.runtime.faults as jfaults
import repro_torch.core
import repro_torch.launch.pregel_run as tcli
import repro_torch.runtime.faults as tfaults
from repro_torch.obs import explain, memwatch, trace

FAULT_PLAN = json.dumps({"seed": 0, "faults": [
    {"site": "superstep", "kind": "worker", "superstep": 5, "worker": 1}]})


@pytest.fixture(autouse=True)
def _clean_globals(monkeypatch):
    """The fault injector and the recorders are process-global: each test
    starts and ends with none armed in either package."""
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    for m in (jfaults, tfaults):
        m.clear()
    yield
    for m in (jfaults, tfaults):
        m.clear()
    for m in (trace, explain, memwatch):
        m.stop()


def _capture_values(monkeypatch, pkg_core):
    """Keep the full value array each CLI gathers (they print its head)."""
    kept = []
    real = pkg_core.gather_values

    def gather(vert, n):
        out = real(vert, n)
        kept.append(out)
        return out
    monkeypatch.setattr(pkg_core, "gather_values", gather)
    return kept


def _run_both(monkeypatch, capsys, jargv, targv):
    """The JAX CLI on ``jargv`` (through ``sys.argv``), then the port's on
    ``targv`` on the CPU. -> (JAX output, its values, port output, its
    values)."""
    jkept = _capture_values(monkeypatch, repro.core)
    monkeypatch.setattr(sys, "argv", ["pregel_run"] + jargv)
    jcli.main()
    jout = capsys.readouterr().out
    tkept = _capture_values(monkeypatch, repro_torch.core)
    assert tcli.main(targv + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    return jout, jkept[-1], tout, tkept[-1]


def _supersteps(out):
    return int(re.search(r"\]: (\d+) supersteps", out).group(1))


def _plan_lines(out):
    return [ln for ln in out.splitlines()
            if ln.startswith(("final plan:", "  superstep "))]


def _recoveries(out):
    return [re.sub(r"restored from \S*/", "restored from ", ln)
            for ln in out.splitlines() if ln.startswith("recovery #")]


MODES = {
    "pagerank_observed": (["--algo", "pagerank", "--explain", "--metrics"],
                          True),
    "sssp_auto": (["--algo", "sssp", "--auto-plan"], False),
    "cc_ooc_disk": (["--algo", "cc", "--ooc", "--budget-partitions", "2",
                     "--memory-budget-bytes", "2000000", "--eviction",
                     "mru"], False),
    "sssp_recover": (["--algo", "sssp", "--recover", "--checkpoint-every",
                      "3"], False),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_matches_the_reference_cli(mode, tmp_path, monkeypatch,
                                       capsys):
    extra, traced = MODES[mode]
    argvs = []
    for tag in ("jax", "torch"):
        argv = ["--dataset", "webmap-tiny", "--parts", "4", "--report",
                str(tmp_path / f"{tag}.json")] + extra
        if "--ooc" in extra:
            argv += ["--disk-dir", str(tmp_path / f"spill-{tag}")]
        if "--recover" in extra:
            argv += ["--checkpoint-dir", str(tmp_path / f"ckpt-{tag}")]
            monkeypatch.setenv("REPRO_FAULT_PLAN", FAULT_PLAN)
        if traced:
            argv += ["--trace", str(tmp_path / f"{tag}_trace.json")]
        argvs.append(argv)
    # each package writes its own files
    jout, jv, tout, tv = _run_both(monkeypatch, capsys, *argvs)

    assert _supersteps(tout) == _supersteps(jout)
    assert _plan_lines(tout) == _plan_lines(jout)
    if mode.startswith("pagerank"):
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(tv, jv)
    for out in (jout, tout):
        assert "0 schema violation(s)" in out
    assert _recoveries(tout) == _recoveries(jout)
    if mode == "sssp_recover":
        assert len(_recoveries(tout)) == 1
        rep = json.loads((tmp_path / "torch.json").read_text())
        assert rep["faults"]["injected"]["specs"][0]["fired"] == 1
        assert rep["faults"]["recovery"][0]["healthy_workers"] == 3
    if mode == "sssp_auto":
        assert "1 plan switch(es)" in tout
    if mode == "cc_ooc_disk":
        assert "disk tier: mean page hit rate" in tout
        rep = json.loads((tmp_path / "torch.json").read_text())
        assert rep["memory_peaks"]["ssd_spill_bytes"] > 0
    if traced:
        from repro.obs.export import validate_chrome_trace as jvalid
        from repro_torch.obs.export import validate_chrome_trace
        obj = json.loads((tmp_path / "torch_trace.json").read_text())
        assert validate_chrome_trace(obj) == jvalid(obj)
        steps = [e for e in obj["traceEvents"]
                 if e["ph"] == "X" and e["name"] == "superstep"]
        assert len(steps) == _supersteps(tout)
        # the audit table and the metrics lines of both CLIs
        for out in (jout, tout):
            assert out.count("metrics @ superstep") == _supersteps(out)
            assert "**15 supersteps**" in out


@pytest.mark.parametrize("argv", [["--dryrun"], ["--devices", "2"],
                                  ["--mesh", "host"],
                                  ["--mesh", "production"]])
def test_multi_device_modes_stop_with_their_slice(argv, capsys, tmp_path):
    """--devices N, --mesh host and --mesh production select the sharded
    driver; --dryrun writes its record at 256 ranks with no device, and
    --mesh production outside a 256-rank world stops, naming the
    count."""
    if argv in (["--devices", "2"], ["--mesh", "host"]):
        args = tcli.parse_args(argv + ["--device", "cpu"])
        assert tcli.sharded(args)
        return
    if argv == ["--dryrun"]:
        assert tcli.main(argv + ["--device", "cpu", "--mesh", "single",
                                 "--out", str(tmp_path)]) == 0
        rec = json.loads((tmp_path / "baseline_pregelix-pagerank_"
                          "paper-large_single.json").read_text())
        assert (rec["status"], rec["chips"]) == ("ok", 256)
        assert "ROADMAP" not in capsys.readouterr().out
        return
    assert tcli.sharded(tcli.parse_args(argv + ["--device", "cpu"]))
    with pytest.raises(RuntimeError, match="256-rank"):
        tcli.main(argv + ["--device", "cpu"])


def test_the_card_is_the_default(monkeypatch, capsys):
    """Without --device the job runs on the card; without one it stops
    and names --device cpu instead of falling back."""
    assert tcli.build_parser().parse_args([]).device == "cuda"
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tcli.main(["--algo", "cc"])
    assert "--device cpu" in capsys.readouterr().err


def test_inconsistent_flags_stop(capsys):
    for argv, needle in (
            (["--recover"], "--checkpoint-dir"),
            (["--ooc", "--parts", "4", "--budget-partitions", "3"],
             "must divide"),
            (["--ooc", "--memory-budget-bytes", "100"], "--disk-dir")):
        with pytest.raises(SystemExit):
            tcli.main(argv + ["--device", "cpu"])
        assert needle in capsys.readouterr().err
