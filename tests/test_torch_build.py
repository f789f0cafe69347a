"""The kernels' build, without nvcc: a library's file name hashes its source
and every header the source includes from ``csrc/``, so an edited header
rebuilds each library that uses it and no other, and a stale library is never
loaded. The tests read a copy of ``csrc/`` (``build.CSRC`` pointed at it)."""

import shutil

import pytest

from repro_torch.kernels import build

KERNELS = ("flash_fwd", "flash_bwd", "grouped_gemm", "ssd_fwd", "ssd_bwd")
SSD = ("ssd_fwd", "ssd_bwd")        # include ssd_sm90.cuh, which includes sm90.cuh
HOPPER = KERNELS                    # every source reaches sm90.cuh


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that build reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_sources_follow_the_includes():
    for name in KERNELS:
        want = [f"{name}.cu"] + (["ssd_sm90.cuh"] if name in SSD else []) + ["sm90.cuh"]
        assert [p.name for p in build.sources(name)] == want, name


def test_library_path_is_stable(csrc):
    assert all(build.library_path(n) == build.library_path(n) for n in KERNELS)
    assert len({build.library_path(n) for n in KERNELS}) == len(KERNELS)


@pytest.mark.parametrize("edited", ["sm90.cuh", "ssd_sm90.cuh", "flash_fwd.cu", "ssd_bwd.cu"])
def test_an_edit_changes_the_paths_of_the_libraries_that_use_it(csrc, edited):
    before = {n: build.library_path(n) for n in KERNELS}
    path = csrc / edited
    path.write_text(path.read_text() + "\n// an edit\n")
    users = {"sm90.cuh": HOPPER, "ssd_sm90.cuh": SSD}.get(edited, (edited[:-3],))
    for n in KERNELS:
        assert (build.library_path(n) != before[n]) == (n in users), n


def test_a_header_included_by_a_header_is_hashed(csrc):
    hdr = csrc / "sm90.cuh"
    hdr.write_text('#include "extra.cuh"\n' + hdr.read_text())
    (csrc / "extra.cuh").write_text("// one\n")
    assert [p.name for p in build.sources("flash_bwd")] == ["flash_bwd.cu", "sm90.cuh",
                                                            "extra.cuh"]
    before = build.library_path("flash_bwd")
    (csrc / "extra.cuh").write_text("// two\n")
    assert build.library_path("flash_bwd") != before


@pytest.mark.parametrize("err,says", [(0 + 2, "cudaError 2"),
                                      (20000, "no tensor-map encoder"),
                                      (20001 + 700, "CUresult 700")])
def test_launch_error_reads_every_entry_points_codes(err, says):
    assert says in build.launch_error(err)
