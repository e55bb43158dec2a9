"""The port's log-mel frontend (audiossl_tpu_torch.frontend) against the JAX
package: the plain log_mel against the XLA log_mel and the ct2/ct Pallas
kernels in interpret mode, the kernel wrapper's CPU path, the kernel's
Cooley-Tukey constants and bin mapping (emulated in NumPy), and the librosa
oracle. All on the CPU, inputs made by numpy from a seed."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiossl_tpu.frontend import mel as jmel
from audiossl_tpu.frontend import pallas_stft
from audiossl_tpu.frontend.stft import LogMelConfig as JaxLogMelConfig
from audiossl_tpu.frontend.stft import log_mel as jax_log_mel
from audiossl_tpu_torch.frontend import FrontendSpec, build_frontend, fused_stft
from audiossl_tpu_torch.frontend import mel as tmel
from audiossl_tpu_torch.frontend.stft import EPS32, EPS64, LogMelConfig, log_mel, reflect_pad
from tests.oracles import librosa_oracle as oracle

RNG = np.random.default_rng(7)
TOL_JAX = 1e-4  # same f32 algorithm on both sides; the JAX suite's own ct2 bound
TOL_ORACLE = 1e-3  # the librosa contract


def _waves(b, n=15200, scale=0.5):
    return (scale * RNG.standard_normal((b, n))).astype(np.float32)


def _port(waves, cfg=LogMelConfig()):
    return log_mel(torch.from_numpy(waves), cfg).numpy()


class TestConstants:
    @pytest.mark.parametrize("n_fft,n_mels", [(1024, 64), (512, 40), (1024, 128)])
    def test_filterbank_window_dft_copies(self, n_fft, n_mels):
        np.testing.assert_array_equal(
            tmel.mel_filterbank(16000, n_fft, n_mels, 60.0, 7800.0),
            jmel.mel_filterbank(16000, n_fft, n_mels, 60.0, 7800.0),
        )
        np.testing.assert_array_equal(tmel.hann_window(n_fft), jmel.hann_window(n_fft))
        for a, b in zip(tmel.rdft_matrices(n_fft), jmel.rdft_matrices(n_fft)):
            np.testing.assert_array_equal(a, b)

    def test_eligibility_matches_jax(self):
        for n_fft in (256, 400, 512, 768, 1024, 2048):
            for hop in (64, 100, 128, 160, 200, 256, 320):
                ours = LogMelConfig(n_fft=n_fft, hop=hop)
                ref = JaxLogMelConfig(n_fft=n_fft, hop=hop)
                assert fused_stft.ct_eligible(ours) == pallas_stft.ct_eligible(ref)
                assert fused_stft.ct2_eligible(ours) == pallas_stft.ct2_eligible(ref)


def _emulate_kernel(waves, cfg):
    """NumPy (float64) model of csrc/log_mel.cu: the radix-N2 stage over the
    window-applied frames, the W_n^{m r} twiddle, the 128-point DFT for
    residues r <= N2/2, the kernel's bin mapping (direct bin, or the mirror
    n_fft - k for 1 <= r < N2/2; each bin written once), then power + EPS64,
    the filterbank over each mel's nonzero range, + EPS32 and log."""
    consts, mel_range = fused_stft.kernel_constants(cfg)
    c = consts.astype(np.float64)
    n, n2 = cfg.n_fft, cfg.n_fft // 128
    r_max, half = n2 // 2 + 1, cfg.n_fft // 2
    sizes = [n, 2 * n2 * r_max, 2 * r_max * 128, 256]
    win, w2, tw, w128, fb = np.split(c, np.cumsum(sizes))
    w2 = w2.reshape(n2, r_max, 2) @ [1, 1j]
    tw = tw.reshape(r_max, 128, 2) @ [1, 1j]
    w128 = w128.reshape(128, 2) @ [1, 1j]
    fb = fb.reshape(cfg.n_mels, half + 1)

    padded = reflect_pad(torch.from_numpy(waves), n).double().numpy()
    frames = np.lib.stride_tricks.sliding_window_view(padded, n, axis=-1)[:, :: cfg.hop]
    x = (frames * win).reshape(*frames.shape[:2], n2, 128)  # [B, F, j, m]
    cr = np.einsum("bfjm,jr->bfrm", x, w2) * tw  # [B, F, r, m]
    t = np.arange(128)
    xk = cr @ w128[np.outer(t, t) & 127]  # [B, F, r, t]: W_128^{m t} with m rows
    power = np.full(frames.shape[:2] + (half + 1,), np.nan)
    for r in range(r_max):
        k = n2 * t + r
        direct = k <= half
        mirror = ~direct & (r >= 1) & (2 * r < n2)
        bins = np.where(direct, k, n - k)[direct | mirror]
        assert np.isnan(power[0, 0, bins]).all(), "a bin written twice"
        power[:, :, bins] = np.abs(xk[:, :, r, direct | mirror]) ** 2
    assert not np.isnan(power).any(), "a bin never written"
    mel = np.stack(
        [(power[..., lo:hi] + np.float32(EPS64)) @ fb[i, lo:hi] for i, (lo, hi) in enumerate(mel_range)],
        axis=1,
    )
    return np.log(mel + np.float32(EPS32))


class TestLogMel:
    def test_matches_jax_log_mel(self):
        waves = _waves(3)
        ours, ref = _port(waves), np.asarray(jax_log_mel(jnp.asarray(waves)))
        assert ours.shape == ref.shape == (3, 64, 96)
        assert np.max(np.abs(ours - ref)) <= TOL_JAX

    def test_odd_length_and_single_wave(self):
        wave = _waves(1, n=12345)[0]
        ours, ref = _port(wave), np.asarray(jax_log_mel(jnp.asarray(wave)))
        assert ours.shape == ref.shape
        assert np.max(np.abs(ours - ref)) <= TOL_JAX

    def test_silence_is_finite(self):
        out = _port(np.zeros((2, 15200), np.float32))
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, np.log(np.float32(EPS32)), rtol=1e-5)

    def test_matches_librosa_oracle(self):
        t = np.arange(15200) / 16000.0
        tonal = (0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * np.sin(2 * np.pi * 3100.0 * t)).astype(np.float32)
        waves = np.stack([_waves(1)[0], tonal])
        ours = _port(waves)
        for w, o in zip(waves, ours):
            assert np.max(np.abs(o - oracle.log_mel_oracle(w))) <= TOL_ORACLE

    @pytest.mark.parametrize("cfg", [LogMelConfig(n_mels=128), LogMelConfig(hop=320), LogMelConfig(win_length=400)])
    def test_other_configs_match_jax(self, cfg):
        waves = _waves(2, n=8000)
        jcfg = JaxLogMelConfig(n_mels=cfg.n_mels, hop=cfg.hop, win_length=cfg.win_length)
        ref = np.asarray(jax_log_mel(jnp.asarray(waves), jcfg))
        assert np.max(np.abs(_port(waves, cfg) - ref)) <= TOL_JAX


class TestFusedWrapper:
    def test_cpu_tensor_takes_the_plain_version(self):
        waves = torch.from_numpy(_waves(2))
        before = fused_stft.log_mel_fused.launches
        torch.testing.assert_close(fused_stft.log_mel_fused(waves), log_mel(waves), rtol=0, atol=0)
        assert fused_stft.log_mel_fused.launches == before  # no kernel launch on the CPU

    def test_matches_ct2_interpret(self):
        waves = _waves(5)  # 5 % batch_per_tile(4) != 0
        ours = fused_stft.log_mel_fused(torch.from_numpy(waves)).numpy()
        ref = np.asarray(pallas_stft.log_mel_fused_ct2(jnp.asarray(waves), interpret=True, split=True))
        assert np.max(np.abs(ours - ref)) <= TOL_JAX

    def test_matches_ct_interpret_at_hop_100(self):
        cfg = LogMelConfig(hop=100)
        jcfg = JaxLogMelConfig(hop=100)
        assert fused_stft.ct_eligible(cfg) and not fused_stft.ct2_eligible(cfg)
        assert math.gcd(cfg.hop, 128) == 4
        waves = _waves(2, n=8000)
        ours = fused_stft.log_mel_fused(torch.from_numpy(waves), cfg).numpy()
        ref = np.asarray(pallas_stft.log_mel_fused_ct(jnp.asarray(waves), jcfg, frames_per_tile=128, interpret=True))
        assert np.max(np.abs(ours - ref)) <= TOL_JAX

    @pytest.mark.parametrize(
        "cfg,n",
        [
            (LogMelConfig(), 12345),
            (LogMelConfig(hop=100), 4000),
            (LogMelConfig(n_fft=512, hop=128, n_mels=40), 4000),
            (LogMelConfig(n_fft=768, n_mels=32), 4000),
        ],
    )
    def test_kernel_algorithm_matches_plain(self, cfg, n):
        """The kernel's constants and bin mapping, run in NumPy, reproduce the
        plain log-mel for every n_fft family the kernel accepts."""
        waves = _waves(2, n=n)
        assert np.max(np.abs(_emulate_kernel(waves, cfg) - _port(waves, cfg))) <= TOL_JAX

    def test_rejects_other_devices(self):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fused_stft.log_mel_fused(torch.empty((2, 15200), device="meta"))


class TestFrontendSpec:
    def test_logmel_kind(self):
        spec = build_frontend({"type": "raw_wav", "sampling_rate": 16000, "n_mels": 64})
        assert spec == FrontendSpec("logmel", 64, 16000)
        assert spec.num_frames(15200) == 96
        waves = torch.from_numpy(_waves(2))
        torch.testing.assert_close(spec(waves), log_mel(waves), rtol=0, atol=0)

    def test_fbank_kind_is_not_ported(self):
        spec = build_frontend({"type": "fbank", "sampling_rate": 16000, "n_mels": 128, "target_length": 1024})
        with pytest.raises(NotImplementedError, match="SS-MAST"):
            spec(torch.zeros((1, 16000)))
