"""Async checkpoints, the streaming frontends and the magnitude fbank of the
port against the JAX package, on the CPU; inputs are numpy from a seed.

* train/checkpoint.py: a save returns once the state is copied to host
  memory, the loop's later in-place updates do not reach what is written,
  and the state read back equals the state saved, as JAX's orbax restore
  does (the same arrays through ``audiossl_tpu.train.checkpoint`` and back
  are compared exactly); a load waits for the writer in flight and never
  sees a half-written step (the planted fault, a load that does not wait,
  reads the previous step); pruning keeps at most keep_last + 1 steps on
  disk while a write is in flight (JAX's bound), keep_last after it; the
  encoder-only save is what ``newest_encoder`` finds; a write that failed
  in the background leaves the preemption guard's handlers put back, and
  does not hide an exception the guarded block raised;
* frontend/streaming.py: chunked frames against JAX's streaming frontends
  and the port's batch frontend, 1e-4 of max(1, max|ref|) (the frontend
  tests' JAX bound), the batch frontend 1e-6 relative;
* the magnitude fbank (``use_power=False``): the plain version against
  JAX's plain ``kaldi_fbank`` at 1e-4 of max(1, max|ref|), the rows kernel's
  FFT-design model in magnitude mode against it at the same bound, the
  power mode bit for bit as before; the planted fault, a magnitude fbank
  that keeps the power, is 100 times the bound off.
"""
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiossl_tpu.frontend import streaming as jstreaming
from audiossl_tpu.frontend.fbank import FbankConfig as JaxFbankConfig
from audiossl_tpu.frontend.fbank import kaldi_fbank as jax_kaldi_fbank
from audiossl_tpu.frontend.stft import LogMelConfig as JaxLogMelConfig
from audiossl_tpu_torch.frontend import fbank as tfb
from audiossl_tpu_torch.frontend import fused_stft
from audiossl_tpu_torch.frontend.stft import EPS32, LogMelConfig, log_mel
from audiossl_tpu_torch.frontend.streaming import StreamingFbank, StreamingLogMel
from audiossl_tpu_torch.train import checkpoint as ckpt
from tests.test_torch_port_frontend import _emulate_fft_rows

RNG = np.random.default_rng(1717)
TOL_JAX = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bound(ref):
    return TOL_JAX * max(1.0, float(np.abs(ref).max()))


# ---------------------------------------------------------------- async checkpoints


def _state():
    return {"objective": {"w": torch.from_numpy(RNG.standard_normal((64, 32)).astype(np.float32)),
                          "queue_ptr": torch.tensor(5)},
            "generator": [torch.Generator().manual_seed(3).get_state()], "step": 7, "config": {"run": {"a": 1}}}


class SlowWriter:
    """``torch.save`` in the checkpoint module held between writing the
    first bytes of its temporary file and the rest, until ``release``;
    ``started`` is set once the state writer's temporary file exists."""

    def __init__(self, monkeypatch):
        self.started, self.go = threading.Event(), threading.Event()
        original = torch.save

        def save(obj, f, *a, **kw):
            with open(f, "wb") as fh:
                fh.write(b"PK\x03\x04half")  # a partial zip where the rename has not come yet
            if os.sep + "state" + os.sep in f:  # the state writer's file is on disk (the encoder's may lag)
                self.started.set()
            self.go.wait(30)
            original(obj, f, *a, **kw)

        monkeypatch.setattr(ckpt.torch, "save", save)

    def release(self):
        self.go.set()


def test_async_save_copies_to_host_and_restores_as_jax_does(tmp_path):
    """The save returns with the write in flight; the loop's in-place update
    after it does not reach the file; what is read back equals what was
    saved, exactly, as JAX's orbax save and restore give back its arrays."""
    import jax

    from audiossl_tpu.train import checkpoint as jckpt

    state = _state()
    saved_w = state["objective"]["w"].clone()
    ckpt.save_checkpoint(str(tmp_path / "port"), 1, state, {"enc": saved_w * 2}, config={"run": {}})
    state["objective"]["w"].add_(1.0)  # the next step's in-place update
    back = ckpt.load_checkpoint(str(tmp_path / "port"))
    assert torch.equal(back["objective"]["w"], saved_w) and int(back["objective"]["queue_ptr"]) == 5
    assert back["step"] == 7 and back["config"] == {"run": {"a": 1}}
    assert torch.equal(back["generator"][0], torch.Generator().manual_seed(3).get_state())

    tree = {"w": jnp.asarray(saved_w.numpy())}
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, tree, tree, block=True)
    restored = jckpt.restore_checkpoint(str(tmp_path / "jax"), jax.tree.map(jnp.zeros_like, tree))
    np.testing.assert_array_equal(np.asarray(restored["w"]), back["objective"]["w"].numpy())


@pytest.mark.parametrize("fault", [None, "load_does_not_wait"])
def test_a_write_in_flight_is_never_read_half_written(tmp_path, monkeypatch, fault):
    """Step 1 on disk, step 2's writer held mid-file: its temporary file is
    on disk, its ``2.pt`` not. A load waits for it and reads step 2 whole;
    the planted fault (a load that does not wait) reads step 1, and the
    check that the newest save is what a load returns fails on it."""
    d = str(tmp_path / "chkp")
    ckpt.save_checkpoint(d, 1, {"step": 1}, {}, block=True)
    slow = SlowWriter(monkeypatch)
    ckpt.save_checkpoint(d, 2, {"step": 2}, {})
    assert slow.started.wait(30)
    names = os.listdir(os.path.join(d, "state"))
    assert "2.pt" not in names and any(n.startswith("2.pt.tmp") for n in names)
    if fault:
        monkeypatch.setattr(ckpt, "wait_until_finished", lambda: None)
    threading.Timer(0.2, slow.release).start()
    got = ckpt.load_checkpoint(d)["step"]
    slow.release()
    ckpt._wait("state"), ckpt._wait("encoder")
    assert (got == 2) == (fault is None), got


def test_pruning_keeps_jax_bound_while_a_write_is_in_flight(tmp_path, monkeypatch):
    """keep_last 2: with step 5's write held, steps 3 and 4 stay beside it
    (keep_last + 1 on disk once it lands); ``prune_checkpoints`` waits and
    leaves keep_last."""
    d = str(tmp_path / "chkp")
    for s in range(1, 5):
        ckpt.save_checkpoint(d, s, {"step": s}, {}, keep_last=2, block=True)
    assert ckpt._steps(d, "state") == [3, 4]
    slow = SlowWriter(monkeypatch)
    ckpt.save_checkpoint(d, 5, {"step": 5}, {}, keep_last=2)
    assert slow.started.wait(30) and ckpt._steps(d, "state") == [3, 4]
    slow.release()
    ckpt.wait_until_finished()
    assert ckpt._steps(d, "state") == [3, 4, 5] and ckpt._steps(d, "encoder") == [3, 4, 5]
    ckpt.prune_checkpoints(d, 2)
    assert ckpt._steps(d, "state") == [4, 5] and ckpt._steps(d, "encoder") == [4, 5]


def test_encoder_only_save_is_what_newest_encoder_reads(tmp_path):
    from audiossl_tpu_torch.models.surgery import newest_encoder

    enc = {"w": torch.arange(6.0)}
    ckpt.save_encoder_only(str(tmp_path), 0, enc, block=False)
    ckpt.wait_until_finished()
    path = newest_encoder(str(tmp_path))
    assert path.endswith(os.path.join("encoder", "0.pt"))
    assert torch.equal(torch.load(path, weights_only=True)["w"], enc["w"])


def test_a_failed_write_raises_at_the_next_wait(tmp_path, monkeypatch):
    def broken(obj, f, *a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", broken)
    ckpt.save_checkpoint(str(tmp_path), 1, {"step": 1}, {})
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_until_finished()


@pytest.mark.parametrize("block", ["returns", "raises"])
def test_the_preemption_guard_puts_its_handlers_back_when_a_write_failed(tmp_path, monkeypatch, caplog, block):
    """A write that failed in the background reaches the guard's exit: the
    previous handler comes back all the same; a block that returns gets the
    write's error, a block that raises keeps its own exception and the
    write's error is logged."""
    import signal

    from audiossl_tpu_torch.train.preemption import PreemptionGuard

    def broken(obj, f, *a, **kw):
        raise OSError("disk full")

    def previous(signum, frame):  # noqa: ARG001 (signal API)
        pass

    monkeypatch.setattr(ckpt.torch, "save", broken)
    before = signal.signal(signal.SIGUSR1, previous)
    try:
        want = OSError if block == "returns" else KeyError
        with pytest.raises(want):
            with PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
                assert guard.installed and signal.getsignal(signal.SIGUSR1) is not previous
                ckpt.save_checkpoint(str(tmp_path), 1, {"step": 1}, {})
                if block == "raises":
                    raise KeyError("the trainer's own fault")
        assert signal.getsignal(signal.SIGUSR1) is previous and not guard.installed
        assert ("disk full" in caplog.text) == (block == "raises")
    finally:
        signal.signal(signal.SIGUSR1, before)


# ---------------------------------------------------------------- streaming


def _stream(sl, wave, first, chunks, kind):
    state, out = sl.start(wave[..., :first])
    outs, pos = [out], first
    for c in chunks:
        state, out = sl.step(state, wave[..., pos:pos + c])
        outs.append(out)
        pos += c
    assert pos == wave.shape[-1]
    if kind == "logmel":
        outs.append(sl.finish(state))
        return np.concatenate([np.asarray(o) for o in outs], axis=-1)
    return np.concatenate([np.asarray(o) for o in outs], axis=-2)


@pytest.mark.parametrize("center,chunks", [(True, [800] * 8), (False, [800] * 8), (True, [320, 4320, 160, 1600])])
def test_streaming_log_mel_matches_jax_and_the_batch_frames(center, chunks):
    first = 1600
    wave = (0.3 * RNG.standard_normal((2, first + sum(chunks)))).astype(np.float32)
    got = _stream(StreamingLogMel(LogMelConfig(center=center)), torch.from_numpy(wave), first, chunks, "logmel")
    want = _stream(jstreaming.StreamingLogMel(JaxLogMelConfig(center=center)), jnp.asarray(wave), first, chunks,
                   "logmel")
    batch = log_mel(torch.from_numpy(wave), LogMelConfig(center=center)).numpy()
    assert got.shape == want.shape == batch.shape
    assert np.abs(got - want).max() <= _bound(want)
    assert np.abs(got - batch).max() <= 1e-6 * np.abs(batch).max()


@pytest.mark.parametrize("use_power", [True, False])
def test_streaming_fbank_matches_jax_and_the_batch_frames(use_power):
    first, chunks = 1600, [800, 2400, 160, 800]
    wave = (0.3 * RNG.standard_normal((2, first + sum(chunks)))).astype(np.float32)
    got = _stream(StreamingFbank(tfb.FbankConfig(use_power=use_power)), torch.from_numpy(wave), first, chunks, "fbank")
    want = _stream(jstreaming.StreamingFbank(JaxFbankConfig(use_power=use_power)), jnp.asarray(wave), first, chunks,
                   "fbank")
    batch = tfb.kaldi_fbank(torch.from_numpy(wave), tfb.FbankConfig(use_power=use_power)).numpy()
    assert got.shape == want.shape == batch.shape
    assert np.abs(got - want).max() <= _bound(want)
    assert np.abs(got - batch).max() <= 1e-6 * np.abs(batch).max()


def test_streaming_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="multiple of hop"):
        StreamingLogMel().start(torch.zeros(1601))
    with pytest.raises(ValueError, match="first chunk too short"):
        StreamingLogMel().start(torch.zeros(480))
    with pytest.raises(ValueError, match="multiple of shift"):
        StreamingFbank().step(torch.zeros(240), torch.zeros(100))
    with pytest.raises(ValueError, match="first chunk too short"):
        StreamingFbank().start(torch.zeros(320))


# ---------------------------------------------------------------- the magnitude fbank


@pytest.mark.parametrize("n", [16000, 12345])
def test_magnitude_fbank_matches_jax_plain_fbank(n):
    waves = (0.5 * RNG.standard_normal((2, n))).astype(np.float32)
    cfg = tfb.FbankConfig(use_power=False)
    got = tfb.kaldi_fbank(torch.from_numpy(waves), cfg).numpy()
    wrapper = fused_stft.kaldi_fbank_fused(torch.from_numpy(waves), cfg).numpy()  # the CPU path is the plain version
    np.testing.assert_array_equal(wrapper, got)
    want = np.asarray(jax_kaldi_fbank(jnp.asarray(waves), JaxFbankConfig(use_power=False)))
    assert got.shape == want.shape and np.abs(got - want).max() <= _bound(want)
    frames = tfb.frame_rows(torch.from_numpy(waves), cfg)
    model = _emulate_fft_rows(frames.reshape(-1, cfg.window_size).numpy(), cfg, "kaldi", magnitude=True)
    assert np.abs(model.reshape(want.shape) - want).max() <= _bound(want)


def test_power_mode_is_unchanged_and_keeping_the_power_fails_the_check():
    """The power mode's plain version is the product it was, bit for bit;
    the planted fault (the magnitude config served by the power mode) lands
    far outside the magnitude bound."""
    waves = (0.5 * RNG.standard_normal((2, 16000))).astype(np.float32)
    cfg = tfb.FbankConfig()
    frames = tfb.frame_rows(torch.from_numpy(waves), cfg)
    bank, mel_t = tfb.device_constants(cfg, frames.device)
    spec = torch.matmul(frames, bank)
    n = mel_t.shape[0]
    before = torch.log(torch.clamp_min(torch.matmul(spec[..., :n].square() + spec[..., n:].square(), mel_t), EPS32))
    assert torch.equal(tfb.kaldi_fbank(torch.from_numpy(waves), cfg), before)
    want = np.asarray(jax_kaldi_fbank(jnp.asarray(waves), JaxFbankConfig(use_power=False)))
    kept_power = before.numpy()
    assert np.abs(kept_power - want).max() > 100 * _bound(want)
