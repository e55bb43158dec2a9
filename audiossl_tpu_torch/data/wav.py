"""Host-side WAV decode + resample + write (a copy of audiossl_tpu.data.wav).

Pure NumPy RIFF/WAVE parsing for PCM8/16/24/32 with mono downmix, and
polyphase FIR resampling (scipy), the equivalent of the reference's
``librosa.core.load(path, sr=16000)``. Serving requests and the chip smoke
run read their WAVs through it.
"""
from __future__ import annotations

import io
import wave

import numpy as np
from scipy.signal import resample_poly


def decode_wav(path) -> tuple[np.ndarray, int]:
    """-> (float32 mono waveform in [-1, 1], sample_rate).

    ``path`` may be a filesystem path or a binary file-like object."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def load_wave(path, target_sr: int = 16000) -> np.ndarray:
    """Decode + resample to ``target_sr`` (librosa.load equivalent);
    ``path`` may be a binary file-like object."""
    data, sr = decode_wav(path)
    if sr != target_sr:
        g = np.gcd(sr, target_sr)
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
    return data


def load_wave_bytes(buf: bytes, target_sr: int = 16000) -> np.ndarray:
    """``load_wave`` of a WAV held in memory (a tar-shard member's bytes)."""
    return load_wave(io.BytesIO(buf), target_sr)


def write_wav(path: str, wave_f32: np.ndarray, sr: int = 16000) -> None:
    """Mono PCM16 WAV from a float waveform in [-1, 1] (clipped)."""
    pcm = np.clip(wave_f32, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
