"""The port stands alone: it imports torch and numpy, never JAX and never
the JAX package (``repro``) — checked by importing it with JAX made
unimportable, and by scanning its sources and chip_smoke.py."""
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
           "repro_torch.obs.trace", "repro_torch.obs.metrics"]


def test_imports_with_jax_unimportable():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "sys.path.insert(0, sys.argv[1])\n"
            "import chip_smoke\n"
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
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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


def test_kernels_are_cuda_sources_in_the_port():
    """Each kernel of the slice is a CUDA source of the port, with its
    note on what it replaces."""
    for name, replaces in (("segment_combine", "segment_combine_pallas"),
                           ("csr_spmv", "edge_gather_pallas"),
                           ("flash_attention", "flash_attention_pallas"),
                           ("moe_gmm", "grouped_matmul_pallas")):
        src = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
        assert "__global__" in src and replaces in src
        assert 'extern "C"' in src
