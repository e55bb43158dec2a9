"""The port's log-mel frontend (audiossl_tpu_torch.frontend) against the JAX
package: the plain log_mel against the XLA log_mel and the ct2/ct Pallas
kernels in interpret mode, the kernel wrapper's CPU path, NumPy models of
the kernel's two designs (the FFT behind in-kernel framing; the
Cooley-Tukey constants and bin mapping), and the librosa oracle. All on the CPU, inputs made by numpy from a seed."""
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
    """NumPy (float64) model of csrc/log_mel.cu's Cooley-Tukey design (the
    widths that are not a power of two; the algorithm holds for every
    n_fft % 256 == 0): the radix-N2 stage over the
    window-applied frames, the W_n^{m r} twiddle, the 128-point DFT for
    residues r <= N2/2, the kernel's bin mapping (direct bin, or the mirror
    n_fft - k for 1 <= r < N2/2; each bin written once), then power + EPS64,
    the filterbank over each mel's nonzero range, + EPS32 and log."""
    consts, mel_range = fused_stft.ct_constants(cfg)
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
        """The fbank kind trains (SS-MAST) and serves (MAST, AST): the
        serving module's features are the spec's own; a fbank spec has no
        log-mel config. (The name dates from before fbank serving was ported.)"""
        from audiossl_tpu_torch.frontend.fbank import FbankConfig, kaldi_fbank

        spec = build_frontend({"type": "fbank", "sampling_rate": 16000, "n_mels": 128, "target_length": 1024})
        assert spec.num_frames(160000) == 1024
        waves = torch.from_numpy(_waves(2, 16000))
        out = spec(waves)
        assert out.shape == (2, 128, 1024)
        want = kaldi_fbank(waves, FbankConfig()).transpose(-1, -2)
        torch.testing.assert_close(out[..., :98], want, rtol=0, atol=0)
        assert not out[..., 98:].any()  # zero-padded to target_length
        with pytest.raises(ValueError, match="no log-mel config"):
            spec.logmel_config()
        from audiossl_tpu_torch.serve.export import build_embedder, seeded_state_dict

        emb = build_embedder(seeded_state_dict("MAST", "tiny", 128, 1024, 0, 0), spec, 16000, device="cpu",
                             encoder_type="MAST", model_size="tiny")
        torch.testing.assert_close(emb.features(waves), out[:, None], rtol=0, atol=0)


class TestFbank:
    """The Kaldi fbank (MAST frontend) and the dense-rows kernel's plain
    version, against the JAX package's XLA fbank, its fused Pallas rows
    kernel in interpret mode (both log modes) and the NumPy Kaldi oracle."""

    TOL_ORACLE = 1e-3

    def _ref_tol(self, ref):
        return TOL_JAX * max(1.0, float(np.abs(ref).max()))

    @pytest.mark.parametrize("n", [16000, 400, 12345])  # 1 s, one frame, frames not a multiple of a tile
    def test_kaldi_fbank_matches_jax(self, n):
        from audiossl_tpu.frontend.fbank import FbankConfig as JaxFbankConfig
        from audiossl_tpu.frontend.fbank import kaldi_fbank as jax_kaldi_fbank
        from audiossl_tpu_torch.frontend.fbank import FbankConfig, kaldi_fbank

        waves = _waves(2, n)
        got = kaldi_fbank(torch.from_numpy(waves), FbankConfig()).numpy()
        cpu_wrapper = fused_stft.kaldi_fbank_fused(torch.from_numpy(waves)).numpy()  # the CPU path is the plain version
        np.testing.assert_array_equal(cpu_wrapper, got)
        for ref in (np.asarray(jax_kaldi_fbank(jnp.asarray(waves), JaxFbankConfig())),
                    np.asarray(pallas_stft.kaldi_fbank_fused(jnp.asarray(waves), interpret=True))):
            assert got.shape == ref.shape == (2, 1 + (n - 400) // 160, 128)
            assert np.abs(got - ref).max() <= self._ref_tol(ref)

    def test_kaldi_fbank_matches_oracle(self):
        from tests.oracles.kaldi_oracle import kaldi_fbank_oracle
        from audiossl_tpu_torch.frontend.fbank import kaldi_fbank

        wave = _waves(1, 16000)[0]
        got = kaldi_fbank(torch.from_numpy(wave)).numpy()
        assert np.abs(got - kaldi_fbank_oracle(wave)).max() <= self.TOL_ORACLE

    def test_dense_librosa_rows_match_jax_kernel(self):
        waves = _waves(2)
        ref = np.asarray(pallas_stft.log_mel_fused(jnp.asarray(waves), frames_per_tile=64, interpret=True))
        got = fused_stft.log_mel_dense_fused(torch.from_numpy(waves)).numpy()
        assert got.shape == ref.shape == (2, 64, 96)
        assert np.abs(got - ref).max() <= self._ref_tol(ref)

    def test_pad_trim_and_constants(self):
        from audiossl_tpu.frontend import fbank as jfb
        from audiossl_tpu_torch.frontend import fbank as tfb

        np.testing.assert_array_equal(tfb.kaldi_mel_banks(128, 512, 16000), jfb.kaldi_mel_banks(128, 512, 16000))
        np.testing.assert_array_equal(tfb.hanning_sym(400), jfb.hanning_sym(400))
        x = np.random.default_rng(0).standard_normal((2, 5, 3)).astype(np.float32)
        for t in (3, 5, 8):
            np.testing.assert_array_equal(tfb.pad_or_trim_frames(torch.from_numpy(x), t).numpy(),
                                          np.asarray(jfb.pad_or_trim_frames(jnp.asarray(x), t)))
        bank, mel_t = tfb.fbank_constants(tfb.FbankConfig())
        assert bank.shape == (400, 2 * 257) and mel_t.shape == (257, 128) and not mel_t[-1].any()  # Nyquist column

    def test_logmel_features_routes_other_widths_to_the_rows_kernel(self):
        """n_fft = 400 is not ct_eligible: on a CUDA tensor logmel_features
        launches the rows kernel in librosa mode (the dense design), whose
        TPU counterpart is log_mel_fused. On the CPU it is the plain version;
        both JAX functions agree with it."""
        from audiossl_tpu_torch.frontend import logmel_features

        cfg, jcfg = LogMelConfig(n_fft=400, hop=160), JaxLogMelConfig(n_fft=400, hop=160)
        assert not fused_stft.ct_eligible(cfg) and not fused_stft.fft_width(fused_stft.rows_constants(cfg).n)
        waves = _waves(2, n=8000)
        before = dict(fused_stft.fused_rows.launches)
        got = logmel_features(torch.from_numpy(waves), cfg).numpy()
        assert fused_stft.fused_rows.launches == before  # no kernel launch on the CPU
        for ref in (np.asarray(jax_log_mel(jnp.asarray(waves), jcfg)),
                    np.asarray(pallas_stft.log_mel_fused(jnp.asarray(waves), jcfg, frames_per_tile=64, interpret=True))):
            assert got.shape == ref.shape == (2, 64, 51)
            assert np.abs(got - ref).max() <= self._ref_tol(ref)

    def test_fused_rows_wrappers_refuse_what_the_kernel_does_not_take(self):
        from audiossl_tpu_torch.frontend.fbank import FbankConfig

        with pytest.raises(ValueError, match="CPU or CUDA"):
            fused_stft.kaldi_fbank_fused(torch.empty((2, 16000), device="meta"))
        with pytest.raises(ValueError, match="contiguous f32"):
            fused_stft.fused_rows(torch.zeros((4, 400)), FbankConfig(), "kaldi")  # the kernel takes card tensors only
        with pytest.raises(ValueError, match="mode"):
            fused_stft.fused_rows_plain(torch.zeros((1, 400)), torch.zeros((400, 514)), torch.zeros((257, 128)), "htk")


def _emulate_fft_rows(frames: np.ndarray, cfg, mode: str, magnitude: bool = False) -> np.ndarray:
    """f32 NumPy model of csrc/fused_rows.cu's FFT design, from the
    constants the wrapper hands it (fused_stft.rows_constants): window, pack
    even/odd samples as M = N/2 complex points, radix-4 Stockham passes (a
    radix-2 pass last where log2 M is odd) with the f32 twiddle table, the
    split post-pass X[k] = E + W_N^k O, power, the bins below n_dense from
    the dense design's arithmetic, each filter over its packed nonzero
    weights (``magnitude``: over the square root of each bin's power, the
    Kaldi magnitude mode), and the mode's log."""
    c = fused_stft.rows_constants(cfg)
    n, m = c.n, c.n // 2
    tw = (c.twiddle[:, 0] + 1j * c.twiddle[:, 1]).astype(np.complex64)
    x = np.zeros((frames.shape[0], n), np.float32)
    x[:, : frames.shape[1]] = frames * c.window
    z = (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64)

    def stockham(z, ns, radix):
        q = m // radix
        j = np.arange(q)
        k = j & (ns - 1)
        a = [z[:, j + r * q] * (tw[r * k * (n // (radix * ns))] if r else 1) for r in range(radix)]
        if radix == 4:
            t0, t1, t2, t3 = a[0] + a[2], a[0] - a[2], a[1] + a[3], a[1] - a[3]
            y = [t0 + t2, t1 - 1j * t3, t0 - t2, t1 + 1j * t3]
        else:
            y = [a[0] + a[1], a[0] - a[1]]
        out = np.empty_like(z)
        for r in range(radix):
            out[:, (j - k) * radix + k + r * ns] = y[r]
        return out.astype(np.complex64)

    ns, passes = 1, []
    while ns * 4 <= m:
        z, ns = stockham(z, ns, 4), ns * 4
        passes.append(4)
    if ns < m:
        z, ns = stockham(z, ns, 2), ns * 2
        passes.append(2)
    assert ns == m and passes == [4] * int(math.log2(m) // 2) + [2] * int(math.log2(m) % 2)
    k = np.arange(m + 1)
    zk, zc = z[:, k & (m - 1)], np.conj(z[:, (m - k) & (m - 1)])
    spec = np.complex64(0.5) * (zk + zc) + tw[k] * ((zk - zc) * np.complex64(-0.5j))
    power = (spec.real**2 + spec.imag**2).astype(np.float32)
    # bins below n_dense: the dense design's arithmetic, an FMA chain over the
    # taps against the window-folded bank (each step exact in float64, then rounded)
    if c.n_dense:
        acc = np.zeros((frames.shape[0], 2 * c.n_dense), np.float32)
        cols = c.bank[:, np.r_[0 : c.n_dense, n // 2 + 1 : n // 2 + 1 + c.n_dense]].astype(np.float64)
        for t in range(frames.shape[1]):
            acc = (acc + frames[:, t : t + 1].astype(np.float64) * cols[t]).astype(np.float32)
        power[:, : c.n_dense] = acc[:, : c.n_dense] ** 2 + acc[:, c.n_dense :] ** 2
    mel = np.zeros((frames.shape[0], len(c.mel_range)), np.float32)
    for i, (lo, hi) in enumerate(c.mel_range):
        w = c.fb_packed[c.mel_off[i]: c.mel_off[i] + hi - lo]
        p = np.sqrt(power[:, lo:hi]) if magnitude else power[:, lo:hi] + (
            np.float32(EPS64) if mode == "librosa" else np.float32(0))
        mel[:, i] = p @ w
    if mode == "librosa":
        return np.log(mel + np.float32(EPS32))
    return np.log(np.maximum(mel, np.float32(EPS32)))


@pytest.mark.parametrize(
    "kind,n",
    [("kaldi", 16000), ("kaldi", 12345), ("librosa", 15200), ("librosa", 4000), ("librosa-512", 4000)],
)
def test_fft_rows_model_matches_plain_and_jax(kind, n):
    """The FFT design (N = 512 for Kaldi's 400-sample rows, 1024 for librosa;
    N = 512 with an odd log2(N/2), so a radix-2 pass) against the plain
    version on the same frames and against the JAX package's fused rows
    kernel in interpret mode, all within 1e-4 of max(1, max|ref|)."""
    from audiossl_tpu.frontend.fbank import FbankConfig as JaxFbankConfig
    from audiossl_tpu_torch.frontend import fbank as tfb
    from audiossl_tpu_torch.frontend.stft import frame_signal

    waves = _waves(2, n)
    wt = torch.from_numpy(waves)
    if kind == "kaldi":
        cfg = tfb.FbankConfig()
        frames = tfb.frame_rows(wt, cfg)
        ref = np.asarray(pallas_stft.kaldi_fbank_fused(jnp.asarray(waves), JaxFbankConfig(), interpret=True))
        mode, shape = "kaldi", (2, frames.shape[1], cfg.num_mel_bins)
    else:
        cfg = LogMelConfig() if kind == "librosa" else LogMelConfig(n_fft=512, hop=128, n_mels=40)
        jcfg = JaxLogMelConfig(n_fft=cfg.n_fft, hop=cfg.hop, n_mels=cfg.n_mels)
        frames = frame_signal(wt, cfg.n_fft, cfg.hop, cfg.center)
        ref = np.asarray(pallas_stft.log_mel_fused(jnp.asarray(waves), jcfg, frames_per_tile=64, interpret=True))
        ref = np.swapaxes(ref, -1, -2)
        mode, shape = "librosa", (2, frames.shape[1], cfg.n_mels)
    rows = frames.reshape(-1, frames.shape[-1]).contiguous()
    c = fused_stft.rows_constants(cfg)
    assert fused_stft.fft_width(c.n) and c.n == (512 if kind != "librosa" else 1024)
    assert c.n_dense == (32 if kind == "kaldi" else 0)
    got = _emulate_fft_rows(rows.numpy(), cfg, mode)
    plain = fused_stft.fused_rows_plain(rows, torch.from_numpy(c.bank), torch.from_numpy(c.mel_t), mode).numpy()
    for want in (plain, ref.reshape(-1, shape[-1])):
        assert got.shape == want.shape == (shape[0] * shape[1], shape[2])
        assert np.abs(got - want).max() <= TOL_JAX * max(1.0, float(np.abs(want).max()))


def _emulate_fft_log_mel(waves: np.ndarray, cfg: LogMelConfig, tile: int = 16) -> np.ndarray:
    """f32 NumPy model of csrc/log_mel.cu's FFT design: the wrapper's reflect
    pad, then per (clip, tile of ``tile`` frames) the staged sample span,
    (tile - 1) * hop + n_fft samples with zeros past the wave, each frame of
    the tile read from the span at f * hop, then the FFT schedule the kernel
    shares with the rows kernel (_emulate_fft_rows in librosa mode: window,
    even/odd packing, Stockham passes, split post-pass, power, the bins below
    n_dense from the window-folded bank, packed mel, log) -> [B, n_mels, n_frames]."""
    wt = torch.from_numpy(waves)
    padded = (reflect_pad(wt, cfg.n_fft) if cfg.center else wt).numpy()
    b, n = padded.shape
    n_frames = 1 + (n - cfg.n_fft) // cfg.hop
    span = (tile - 1) * cfg.hop + cfg.n_fft
    frames = np.empty((b, n_frames, cfg.n_fft), np.float32)
    for frame0 in range(0, n_frames, tile):
        staged = np.zeros((b, span), np.float32)
        piece = padded[:, frame0 * cfg.hop: frame0 * cfg.hop + span]
        staged[:, : piece.shape[1]] = piece
        for f in range(min(tile, n_frames - frame0)):
            frames[:, frame0 + f] = staged[:, f * cfg.hop: f * cfg.hop + cfg.n_fft]
    rows = _emulate_fft_rows(frames.reshape(-1, cfg.n_fft), cfg, "librosa")
    return rows.reshape(b, n_frames, cfg.n_mels).transpose(0, 2, 1)


@pytest.mark.parametrize(
    "cfg,n",
    [
        (LogMelConfig(), 15200),
        (LogMelConfig(hop=100), 8000),
        (LogMelConfig(n_fft=512, hop=128, n_mels=40), 4000),
        (LogMelConfig(n_fft=2048, hop=512, n_mels=128), 16000),
        (LogMelConfig(n_fft=256, hop=64, n_mels=64), 4000),
        (LogMelConfig(n_mels=128), 8000),
    ],
)
def test_fft_log_mel_model_matches_plain_and_jax(cfg, n):
    """The log-mel kernel's FFT design (every power-of-two n_fft) against the
    plain log_mel and against JAX's log_mel_fused_ct2 in interpret mode
    (log_mel_fused_ct where the hop is not ct2_eligible), within
    1e-4 * max(1, max|ref|). At n_fft 256 with 64 mels the lowest filters
    pass one bin alone; those bins come from the dense arithmetic."""
    assert fused_stft.log_mel_design(cfg) == "fft"
    c = fused_stft.kernel_constants(cfg)
    widths = c.mel_range[:, 1] - c.mel_range[:, 0]
    assert c.n_dense == (32 if (widths == 1).any() else 0) and (c.n_dense > 0) == (cfg.n_fft == 256)
    waves = _waves(2, n=n)
    got = _emulate_fft_log_mel(waves, cfg)
    jcfg = JaxLogMelConfig(n_fft=cfg.n_fft, hop=cfg.hop, n_mels=cfg.n_mels)
    if fused_stft.ct2_eligible(cfg):
        jax_ref = pallas_stft.log_mel_fused_ct2(jnp.asarray(waves), jcfg, interpret=True, split=True)
    else:
        jax_ref = pallas_stft.log_mel_fused_ct(jnp.asarray(waves), jcfg, frames_per_tile=128, interpret=True)
    for want in (_port(waves, cfg), np.asarray(jax_ref)):
        assert got.shape == want.shape == (2, cfg.n_mels, cfg.num_frames(n))
        assert np.abs(got - want).max() <= TOL_JAX * max(1.0, float(np.abs(want).max()))


def test_log_mel_designs_and_design_flops():
    """Power-of-two widths take the FFT design, 768 the Cooley-Tukey one;
    at the serving shape the FFT design does about 0.83 GFLOP (the function
    needs 0.76), the Cooley-Tukey design about 13.7."""
    assert [fused_stft.log_mel_design(LogMelConfig(n_fft=n)) for n in (256, 512, 768, 1024, 2048)] == [
        "fft", "fft", "cooley-tukey", "fft", "fft"]
    frames = 256 * LogMelConfig().num_frames(15200)
    fft = fused_stft.design_flops(LogMelConfig(), frames)
    assert 0.8e9 < fft < 0.86e9
    consts, mel_range = fused_stft.ct_constants(LogMelConfig(n_fft=768, n_mels=32))
    assert consts.dtype == np.float32 and mel_range.shape == (32, 2)
