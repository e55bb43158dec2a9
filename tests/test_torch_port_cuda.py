"""The port's CUDA kernels on the card, against their plain versions (marked
``cuda``; they skip on a machine without a CUDA device). Run on a GPU host:

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda

chip_smoke.py makes the same checks at the serving shapes; these are the
small-shape edge cases."""
import numpy as np
import pytest
import torch

from audiossl_tpu_torch.frontend import fused_stft
from audiossl_tpu_torch.frontend.stft import LogMelConfig, log_mel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "cfg,shape",
    [
        (LogMelConfig(), (3, 15200)),
        (LogMelConfig(), (1, 12345)),
        (LogMelConfig(hop=100), (2, 8000)),
        (LogMelConfig(n_fft=512, hop=128, n_mels=40), (2, 4000)),
        (LogMelConfig(n_fft=768, n_mels=32), (2, 4000)),
        (LogMelConfig(n_fft=2048, hop=512, n_mels=128), (2, 16000)),
        (LogMelConfig(center=False), (2, 15200)),
    ],
)
def test_log_mel_kernel_matches_plain(cuda, cfg, shape):
    w = torch.from_numpy((0.5 * np.random.default_rng(0).standard_normal(shape)).astype(np.float32)).to(cuda)
    before = fused_stft.log_mel_fused.launches
    got = fused_stft.log_mel_fused(w, cfg)
    want = log_mel(w, cfg)
    torch.cuda.synchronize()
    assert fused_stft.log_mel_fused.launches == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-3  # the librosa contract


def test_log_mel_kernel_single_wave_and_silence(cuda):
    got = fused_stft.log_mel_fused(torch.zeros(15200, device=cuda))
    assert got.shape == (64, 96) and torch.isfinite(got).all()
