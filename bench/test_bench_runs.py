"""CPU tests that drive whole runs of the harness at small sizes, past the
command's look for a card: a sound run comes out correct and reports its
cell's metrics; a run with the timed path broken underneath comes out not
correct; and the command itself refuses to run without a card."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.core.connector as connector
import repro_torch.core.driver as driver
from bench import harness, manifest as mf
from bench.test_bench_parts import cell_of

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"graph500-22": {"scale": 8},
         "btc-14m": {"vertices": 256, "pairs": 1150}}
SEED = 2 ** 31 + 17


def run(workload, trace=False, seed=SEED):
    """A CPU run of <config>.<mix>, in BENCHMARK.json or not yet."""
    cell = cell_of(workload)
    return harness.run_cell(workload, seed, 0.01, trace, device="cpu",
                            overrides=SMALL[cell["config"]], cell=cell,
                            log=lambda *a: None)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", ["graph500-22.pagerank",
                                      "btc-14m.pagerank", "graph500-22.sssp",
                                      "btc-14m.sssp"])
def test_sound_run_is_correct(workload, trace):
    out = run(workload, trace)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= (harness.TRACE_JOBS if trace else 1)
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    want = {m["name"] for m in mf.metrics_of(mf.load(), workload, trace)}
    # on the CPU no allocator peak and no kernel is read
    assert set(out["metrics"]) <= want
    assert "setup_s" in out["metrics"] or trace
    assert ("breakdown" in out) == trace
    json.dumps(out)


def _unchanged(monkeypatch):
    monkeypatch.setattr(driver, "make_superstep",
                        lambda program, plan, ec: lambda v, m, g: (v, m, g))


def _half_dropped(monkeypatch):
    real = connector.exchange_emulated

    def half(b_dst, b_pay, b_val):
        r_dst, r_pay, r_val = real(b_dst, b_pay, b_val)
        r_val = r_val.clone()
        r_val[..., 1::2] = False
        return r_dst, r_pay, r_val
    monkeypatch.setattr(connector, "exchange_emulated", half)


def _no_exchange(monkeypatch):
    monkeypatch.setattr(connector, "exchange_emulated",
                        lambda b_dst, b_pay, b_val: (b_dst, b_pay, b_val))


def _answer_altered(monkeypatch):
    real = driver.make_superstep

    def make(program, plan, ec):
        step = real(program, plan, ec)

        def altered(v, m, g):
            # +1 on the first live vertex's first finite value column
            v, m, g = step(v, m, g)
            val = v.value.clone()
            ok = (v.vid >= 0)[..., None] & (val < 1e30)
            val[tuple(torch.nonzero(ok)[0])] += 1.0
            v.value = val
            return v, m, g
        return altered
    monkeypatch.setattr(driver, "make_superstep", make)


FAULTS = {"unchanged_state": _unchanged, "half_the_messages": _half_dropped,
          "no_exchange": _no_exchange, "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["graph500-22.pagerank",
                                      "graph500-22.sssp"])
def test_broken_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run(workload)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_command_refuses_without_a_card(tmp_path):
    """Here there is no CUDA: the command exits non-zero and prints no
    result; a directory with only the benchmark's own files does too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--workload", "graph500-22.pagerank", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
    p = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"),
                        *argv], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    bare = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", bare / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    p = subprocess.run([sys.executable, "bench/run.py", *argv], cwd=bare,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""
