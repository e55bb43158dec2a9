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


PTXAS = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112attn_fwd_mmaILi4ELi8EEEvPKfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112attn_fwd_mmaILi4ELi8EEEvPKfi
    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_18attn_dkvEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_18attn_dkvEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
"""


def test_ptxas_report_and_the_build_log_beside_the_library(sources, monkeypatch):
    """ptxas_report reads registers, stack and spills per kernel; build_log
    reads the nvcc output kept beside the current library (empty before a
    build, and after an edit that names a new library)."""
    report = kernels.ptxas_report(PTXAS)
    assert report == {
        "_ZN12_GLOBAL__N_112attn_fwd_mmaILi4ELi8EEEvPKfi": {"stack": 8, "spill_stores": 12, "spill_loads": 12, "registers": 80},
        "_ZN12_GLOBAL__N_18attn_dkvEv": {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 32},
    }
    monkeypatch.setattr(kernels, "BUILD_DIR", str(sources / "build"))
    assert kernels.build_log("k") == ""
    import os

    os.makedirs(os.path.dirname(kernels.library_path("k")), exist_ok=True)
    with open(kernels.library_path("k") + ".log", "w") as f:
        f.write(PTXAS)
    assert kernels.ptxas_report(kernels.build_log("k")) == report
    (sources / "k.cu").write_text((sources / "k.cu").read_text() + "// edited\n")
    assert kernels.build_log("k") == ""
