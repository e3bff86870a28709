"""The kernel build's library key: a library is named by a hash of its
source, of every shared header in ``csrc/`` and of the flags, so an
edited header rebuilds every library (no ``nvcc`` needed to check)."""
import _torch_threads  # noqa: F401  (first: see the module)
import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_editing_a_header_changes_the_library_path(csrc):
    before = build.library_path("k")
    assert build.library_path("k") == before          # stable
    (csrc / "shared.cuh").write_text("// v2\n")
    assert build.library_path("k") != before


def test_adding_a_header_or_editing_the_source_changes_it(csrc):
    before = build.library_path("k")
    (csrc / "other.cuh").write_text("// new\n")
    added = build.library_path("k")
    assert added != before
    (csrc / "k.cu").write_text('#include "shared.cuh"\n// edit\n')
    assert build.library_path("k") != added


def test_flags_are_part_of_the_key(csrc, monkeypatch):
    before = build.library_path("k")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("k") != before
