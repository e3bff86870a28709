"""The port stands alone: it imports torch and numpy, never JAX and never
the JAX package (``repro``) — checked by importing it with JAX made
unimportable, and by scanning its sources, chip_smoke.py and the port's
examples (``examples/*_torch.py``)."""
import _torch_threads  # noqa: F401  (first: see the module)
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = ["repro_torch", "repro_torch.core", "repro_torch.graph",
           "repro_torch.kernels", "repro_torch.kernels.backend",
           "repro_torch.kernels.build", "repro_torch.kernels.csr_spmv",
           "repro_torch.kernels.segment_combine", "repro_torch.planner",
           "repro_torch.configs", "repro_torch.kernels.flash_attention",
           "repro_torch.kernels.flash_attention.ops",
           "repro_torch.kernels.moe_gmm", "repro_torch.models",
           "repro_torch.models.attention", "repro_torch.models.moe",
           "repro_torch.models.ssm", "repro_torch.models.model",
           "repro_torch.configs.gemma3_12b",
           "repro_torch.configs.h2o_danube_3_4b",
           "repro_torch.configs.falcon_mamba_7b",
           "repro_torch.configs.zamba2_1_2b",
           "repro_torch.launch.serve", "repro_torch.runtime",
           "repro_torch.runtime.checkpoint", "repro_torch.runtime.failure",
           "repro_torch.runtime.faults", "repro_torch.storage",
           "repro_torch.storage.spillfile", "repro_torch.core.driver",
           "repro_torch.core.superstep", "repro_torch.core.groupby",
           "repro_torch.graph.algorithms", "repro_torch.graph.generators",
           "repro_torch.planner.cost", "repro_torch.planner.optimizer",
           "repro_torch.planner.adaptive", "repro_torch.planner.stats",
           "repro_torch.launch.op_cost", "repro_torch.core.ooc",
           "repro_torch.storage.pager", "repro_torch.storage.io_engine",
           "repro_torch.storage.tiered", "repro_torch.obs",
           "repro_torch.obs.trace", "repro_torch.obs.metrics",
           "repro_torch.obs.progress", "repro_torch.obs.explain",
           "repro_torch.obs.memwatch", "repro_torch.obs.report",
           "repro_torch.obs.export", "repro_torch.launch.pregel_run",
           "repro_torch.core.connector", "repro_torch.core.sharded",
           "repro_torch.launch.mesh", "repro_torch.tree",
           "repro_torch.data", "repro_torch.data.pipeline",
           "repro_torch.optim", "repro_torch.optim.adamw",
           "repro_torch.optim.compress", "repro_torch.models.steps",
           "repro_torch.models.param", "repro_torch.configs.hubert_xlarge",
           "repro_torch.configs.internvl2_76b", "repro_torch.launch.train",
           "repro_torch.kernels.moe_gmm.ops"]


def test_imports_with_jax_unimportable():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "sys.path.insert(0, sys.argv[1])\n"
            "import chip_smoke\n"
            "import importlib.util, pathlib\n"
            "for f in sorted(pathlib.Path(sys.argv[1], 'examples')"
            ".glob('*_torch.py')):\n"
            "    spec = importlib.util.spec_from_file_location(f.stem, f)\n"
            "    spec.loader.exec_module("
            "importlib.util.module_from_spec(spec))\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_repro_import_in_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(files) - len(list(PORT.rglob("*.py"))) == 5
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {name}"


def test_storage_threads_make_no_device_call():
    """The I/O engine's worker threads do disk and numpy work only: the
    storage modules and the metrics they record into never import
    torch, so no CUDA call can run on them; every device copy is the
    out-of-core driver's. (trace.py imports torch.profiler only when a
    tracer is started with torch_annotations=True.)"""
    files = sorted((PORT / "storage").glob("*.py")) + \
        [PORT / "obs" / "metrics.py"]
    for f in files:
        tops = {n.split(".")[0] for n in _imports(f)}
        assert "torch" not in tops, f


def test_obs_package_imports_no_torch():
    """``repro_torch.obs`` (the package the storage modules import
    ``trace`` from) loads without torch: the audit, the memory ledger,
    the report, the exporter and the progress line are framework-free
    copies, and the audit's planner imports wait for a run."""
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "import repro_torch.obs\n"
            "from repro_torch.obs import (explain, memwatch, report, trace,"
            " write_chrome_trace, fmt_plan, progress_line)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    files = [PORT / "obs" / f"{m}.py" for m in
             ("progress", "explain", "memwatch", "report", "export")]
    for f in files:
        tops = {n.split(".")[0] for n in _imports(f)}
        assert "torch" not in tops, f


def test_kernels_are_cuda_sources_in_the_port():
    """Each kernel of the slice is a CUDA source of the port, with its
    note on what it replaces."""
    for name, replaces in (("segment_combine", "segment_combine_pallas"),
                           ("csr_spmv", "edge_gather_pallas"),
                           ("scatter_combine", "scatter_combine_dense"),
                           ("flash_attention", "flash_attention_pallas"),
                           ("moe_gmm", "grouped_matmul_pallas")):
        src = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
        assert "__global__" in src and replaces in src
        assert 'extern "C"' in src
