"""The frontend calls' least time (counts.frontend_bound of each call's
shapes) over their device time in the traced window, in %.

``WRAPS`` names the port's entry functions of the layer, each with the
least time of one call from its arguments; the traced window's spans wrap
them (``harness/trace.py:Spans``)."""
from portbench import counts
from portbench.metrics import roofline
from portbench.reference import frontend as ref_frontend

LAYER = "frontend"
FUSED = "audiossl_tpu_torch.frontend.fused_stft"


def _fbank_bound(wave, cfg=None, *rest, **kw):
    from audiossl_tpu_torch.frontend import fused_stft

    cfg = cfg or fused_stft.fbankmod.FbankConfig()
    n = wave.shape[-1]
    nnz = counts.mel_nnz(ref_frontend.kaldi_banks(cfg.num_mel_bins, cfg.padded_window, cfg.sample_rate))
    return counts.frontend_bound("fbank", wave.numel() // n, n, cfg.num_mel_bins, cfg.num_frames(n), nnz)


def _logmel_bound(wave, cfg=None, *rest, **kw):
    from audiossl_tpu_torch.frontend import fused_stft

    cfg = cfg or fused_stft.LogMelConfig()
    n = wave.shape[-1]
    nnz = counts.mel_nnz(ref_frontend.slaney_banks(cfg.n_mels, cfg.n_fft, cfg.sample_rate))
    return counts.frontend_bound("logmel", wave.numel() // n, n, cfg.n_mels, cfg.num_frames(n), nnz)


WRAPS = [(FUSED, "kaldi_fbank_fused", _fbank_bound),
         (FUSED, "log_mel_fused", _logmel_bound),
         (FUSED, "log_mel_dense_fused", _logmel_bound)]


def read(ctx: dict) -> float | None:
    return roofline.share(ctx, LAYER)
