"""The port's kernel build bookkeeping (``repro_torch.kernels._build``),
which runs without ``nvcc``: the library's name hashes the source and the
``csrc/`` headers it includes, so editing either loads a fresh build."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text(
        '#include <cuda_runtime.h>\n#include "h.cuh"\nint a;\n')
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\nint h;\n')
    (tmp_path / "g.cuh").write_text('#include "h.cuh"\nint g;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    return tmp_path


def test_inputs_follow_local_includes_once(csrc):
    assert [p.name for p in _build.inputs("a")] == ["a.cu", "h.cuh", "g.cuh"]
    assert [p.name for p in _build.inputs("b")] == ["b.cu"]
    assert _build.sources() == ["a", "b"]


@pytest.mark.parametrize("edited", ["a.cu", "h.cuh", "g.cuh"])
def test_editing_a_source_or_an_included_header_renames_the_library(
        csrc, edited):
    before = _build.library_path("a")
    other = _build.library_path("b")
    (csrc / edited).write_text((csrc / edited).read_text() + "int x;\n")
    assert _build.library_path("a") != before
    assert _build.library_path("b") == other


def test_port_sources_hash_their_headers():
    """flash_attention.cu includes sm90.cuh; both name its library."""
    names = [p.name for p in _build.inputs("flash_attention")]
    assert names == ["flash_attention.cu", "sm90.cuh"]


def test_cross_entropy_source_hashes_the_hopper_header():
    """fused_ce.cu's bf16 route is built from sm90.cuh's helpers too."""
    names = [p.name for p in _build.inputs("fused_ce")]
    assert names == ["fused_ce.cu", "sm90.cuh"]


def test_ssd_source_hashes_the_hopper_header():
    """ssd_chunk.cu takes its cp.async helpers from sm90.cuh."""
    names = [p.name for p in _build.inputs("ssd_chunk")]
    assert names == ["ssd_chunk.cu", "sm90.cuh"]


def test_launch_counts_add_reset_and_read():
    def wrapper():
        pass
    wrapper.launches = 0
    _build.count_launch(wrapper)
    _build.count_launch(wrapper)
    assert _build.counts([wrapper]) == {"wrapper": 2}
    _build.reset_counts([wrapper])
    assert wrapper.launches == 0
