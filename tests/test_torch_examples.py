"""The port's examples (``examples/*_torch.py``) on ``--device cpu``,
each held to a plain reference: the quickstart's SSSP distances equal
scipy's unweighted shortest paths (exactly), the webmap PageRank is
within rtol 1e-4 of a float64 power iteration and its latest
checkpoint repartitions onto P = 3, PathMerge conserves its length mass
(exactly n), and the LM trainer's loss falls. The references are chip_smoke.py's, which phase 16
holds the same examples to on the card."""
import _torch_threads  # noqa: F401  (first: see the module)
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

from repro_torch.graph.algorithms import INF  # noqa: E402


def _example(name: str):
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_scipy_hops(capsys):
    res = _example("quickstart").main(["--device", "cpu"])
    hops = chip_smoke.sssp_reference(res["edges"], res["n"], 0)
    want = np.where(np.isinf(hops), np.float32(INF), hops).astype(np.float32)
    np.testing.assert_array_equal(res["dist"], want)
    out = capsys.readouterr().out
    assert f"reached {int(np.isfinite(hops).sum())} / {res['n']} vertices" \
        in out
    assert f"max finite distance: {int(hops[np.isfinite(hops)].max())}" in out


def test_pagerank_webmap_matches_power_iteration(capsys):
    res = _example("pagerank_webmap").main(["--device", "cpu"])
    ref = chip_smoke.pagerank_reference(res["edges"], res["n"],
                                        res["iterations"])
    np.testing.assert_allclose(res["ranks"], ref, rtol=1e-4, atol=0)
    assert res["result"].supersteps == res["iterations"]
    assert res["repartitioned"].vid.shape[0] == 3
    assert res["recovered_superstep"] == 10
    out = capsys.readouterr().out
    assert "onto P=3 partitions: (3, " in out and "top-5:" in out


def test_path_merge_conserves_mass(capsys):
    res = _example("path_merge_genomix").main(["--device", "cpu"])
    assert res["mass"] == res["n"]
    assert 0 < res["alive"] < res["n"]
    assert f"mass conserved: {res['n']} == {res['n']}" in \
        capsys.readouterr().out


def test_train_lm_loss_falls(capsys):
    """20 steps of the reduced h2o-danube on the CPU: the loss at step 20
    (the last logged) is below step 1's (the example's own assert)."""
    res = _example("train_lm").main(["--device", "cpu", "--steps", "20",
                                     "--global-batch", "4",
                                     "--seq-len", "32"])
    assert res["last"] < res["first"]
    assert [h[0] for h in res["result"].hist] == [1, 20]
    assert "OK: loss improved" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["quickstart", "pagerank_webmap",
                                  "path_merge_genomix", "train_lm"])
def test_the_card_is_the_default(name, monkeypatch, capsys):
    """Without --device the example runs on the card; with no card it
    stops and names --device cpu."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _example(name).main([])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
