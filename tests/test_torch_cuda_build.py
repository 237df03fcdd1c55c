"""The kernel build's cache key (CPU only): a library's path hashes its
``.cu`` source and every ``csrc/`` header that source includes, directly or
through another header, so an edited header never leaves a stale library."""

from blazr_tpu_torch.utils import cuda_build


def _tree(tmp_path):
    (tmp_path / "a.cuh").write_text("// a\n")
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "b.cuh"\n')
    (tmp_path / "plain.cu").write_text("// no local headers\n")


def test_sources_follow_local_includes(tmp_path, monkeypatch):
    _tree(tmp_path)
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    assert [p.name for p in cuda_build._sources("k")] == ["k.cu", "b.cuh", "a.cuh"]
    assert [p.name for p in cuda_build._sources("plain")] == ["plain.cu"]


def test_editing_a_header_changes_the_library_path(tmp_path, monkeypatch):
    _tree(tmp_path)
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before, plain = cuda_build._lib_path("k"), cuda_build._lib_path("plain")
    (tmp_path / "a.cuh").write_text("// a, edited\n")
    after = cuda_build._lib_path("k")
    assert after != before and after.name.startswith("libk-")
    assert cuda_build._lib_path("plain") == plain
    (tmp_path / "a.cuh").write_text("// a\n")
    assert cuda_build._lib_path("k") == before


def test_the_repo_kernels_hash_their_shared_header():
    for name in ("qmm", "qmm_int8", "qmm_stream"):
        assert [p.name for p in cuda_build._sources(name)] == [f"{name}.cu", "hopper.cuh"]


def test_the_layout_kernels_hash_the_split_header():
    """B5 and B6 share pa_split.cuh, which includes hopper.cuh: an edit to
    either rebuilds both."""
    for name in ("pa_wide", "pa_headmajor"):
        assert [p.name for p in cuda_build._sources(name)] == [
            f"{name}.cu", "pa_split.cuh", "hopper.cuh"]
