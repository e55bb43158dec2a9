"""The port's kernel build cache (audiossl_tpu_torch.kernels): a library is
named by a hash of its source and of the local headers the source includes,
so that an edit to a shared header (csrc/fft_smem.cuh) builds anew instead
of loading a stale library. Builds nothing: no nvcc is needed."""
import pytest

from audiossl_tpu_torch import kernels


@pytest.fixture
def sources(tmp_path, monkeypatch):
    (tmp_path / "inc").mkdir()
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "shared.cuh"\n__global__ void k() {}\n')
    (tmp_path / "shared.cuh").write_text('#pragma once\n#include "inc/deeper.cuh"\n')
    (tmp_path / "inc" / "deeper.cuh").write_text("// a header included by a header\n")
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path))
    monkeypatch.setattr(kernels, "SOURCES", {"k": "k.cu"})
    return tmp_path


@pytest.mark.parametrize("edited", ["k.cu", "shared.cuh", "inc/deeper.cuh"])
def test_library_path_follows_local_includes(sources, edited):
    before = kernels.library_path("k")
    assert before == kernels.library_path("k")  # stable while nothing changes
    assert [p[len(str(sources)) + 1:] for p in kernels._source_files(str(sources / "k.cu"))] == [
        "k.cu", "shared.cuh", "inc/deeper.cuh"]
    path = sources / edited
    path.write_text(path.read_text() + "// edited\n")
    assert kernels.library_path("k") != before


def test_every_port_source_hashes_its_headers():
    """fused_rows.cu and log_mel.cu both include fft_smem.cuh."""
    import os

    for name in ("fused_rows", "log_mel"):
        files = [os.path.basename(p) for p in kernels._source_files(os.path.join(kernels.CSRC, kernels.SOURCES[name]))]
        assert files == [kernels.SOURCES[name], "fft_smem.cuh"]
    assert [os.path.basename(p) for p in kernels._source_files(os.path.join(kernels.CSRC, "attention.cu"))] == [
        "attention.cu"]
