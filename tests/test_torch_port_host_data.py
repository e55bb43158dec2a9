"""The port's host data against the JAX package's on the CPU: ``host_shard``
(rank-strided slices of the seeded order, wrapped to equal length, the rank
in the window stream), tar-shard rows (member, bare and labelled rows, the
labelled bare row refused, a missing member under ``on_error``), the native
C++ loader built from the port's own source (``csrc/wavloader.cpp`` into
``.torch_build/``) and its byte ranges. Every batch is compared for exact
equality: the same decode, the same windows."""
import hashlib
import os

import numpy as np
import pandas as pd
import pytest
import torch

from audiossl_tpu.data import native as jnative
from audiossl_tpu.data import tar as jtar
from audiossl_tpu.data.pipeline import ManifestLoader as JaxManifestLoader
from audiossl_tpu_torch.data import native, tar
from audiossl_tpu_torch.data.pipeline import ManifestLoader
from audiossl_tpu_torch.data.wav import write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, CLIP, B = 16000, 4096, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread, as every port test file of the suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """13 noise WAVs of 0.5-2 windows (padding and random crops both occur;
    13 is odd, so a world of 2 wraps one clip), a plain and a labelled
    manifest, and 5-clip tar shards of the same clips."""
    root = tmp_path_factory.mktemp("host_data")
    rng = np.random.default_rng(11)
    files = []
    for i in range(13):
        files.append(str(root / f"clip_{i:02d}.wav"))
        write_wav(files[-1], (0.3 * rng.standard_normal(int(rng.integers(CLIP // 2, 2 * CLIP)))).astype(np.float32))
    entries = tar.write_shards(files, str(root / "shards"), shard_clips=5)
    labels = [f"c{i % 3}" for i in range(13)]
    csvs = {}
    for name, col, lab in (("plain", files, None), ("members", entries, None), ("labelled", entries, labels),
                           ("bare", sorted({e.split("::")[0] for e in entries}), None)):
        csvs[name] = str(root / f"{name}.csv")
        pd.DataFrame({"files": col, **({"label": lab} if lab else {})}).to_csv(csvs[name], index=False)
    return {"root": root, "files": files, "entries": entries, "csv": csvs}


def _jax_batches(csv, native_on, monkeypatch, epoch=0, **kw):
    with monkeypatch.context() as m:
        if not native_on:
            m.setattr(jnative, "available", lambda: False)  # the JAX loader's NumPy path
        return list(JaxManifestLoader(csv, num_workers=1, **kw).epoch(epoch))


def _equal(got, want):
    assert len(got) == len(want)
    for (g, gl), (w, wl) in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        if wl is None:
            assert gl is None
        else:
            np.testing.assert_array_equal(gl, wl)


# ---------------------------------------------------------------- host_shard


@pytest.mark.parametrize("world", [2, 3])
def test_host_slices_cover_the_manifest_and_are_disjoint(corpus, world):
    """Every rank's slice has ceil(N / world) clips; together they cover
    the manifest, and only the wrapped tail repeats (13 clips: world - 13 mod
    world extra slots)."""
    loaders = [ManifestLoader(corpus["csv"]["plain"], B, CLIP, SR, seed=3, host_shard=(r, world))
               for r in range(world)]
    order = loaders[0].epoch_order(0)
    slices = [ld.host_slice(order) for ld in loaders]
    per = -(-13 // world)
    assert all(len(s) == per for s in slices)
    assert all(len(ld) == per // B for ld in loaders)
    union = np.concatenate(slices)
    assert set(union.tolist()) == set(range(13))
    _, counts = np.unique(union, return_counts=True)
    assert counts.sum() - 13 == per * world - 13 and counts.max() <= 2
    pair = [set(s.tolist()) for s in slices]
    assert sum(len(a & b) for i, a in enumerate(pair) for b in pair[i + 1:]) == per * world - 13


@pytest.mark.parametrize("world,wire_dtype,workers", [(2, "float32", 1), (3, "int16", 2)])
def test_each_rank_gives_the_jax_loaders_batches(corpus, monkeypatch, world, wire_dtype, workers):
    kw = dict(batch_size=B, clip_samples=CLIP, sample_rate=SR, seed=5, wire_dtype=wire_dtype)
    for r in range(world):
        for epoch in (0, 1):
            want = _jax_batches(corpus["csv"]["plain"], False, monkeypatch, host_shard=(r, world), epoch=epoch, **kw)
            got = list(ManifestLoader(corpus["csv"]["plain"], num_workers=workers, host_shard=(r, world),
                                      native=False, **kw).epoch(epoch))
            assert len(got) == -(-13 // world) // B
            _equal(got, want)


def test_a_world_of_one_gives_the_unsharded_batches(corpus, monkeypatch):
    """host_shard=(0, 1) keeps the order and draws from default_rng((seed,
    epoch, 0)), which NumPy's SeedSequence makes the unsharded stream
    default_rng((seed, epoch)): a one-process run's batches, as in JAX."""
    kw = dict(batch_size=B, clip_samples=CLIP, sample_rate=SR, seed=5)
    one = list(ManifestLoader(corpus["csv"]["plain"], num_workers=1, native=False, **kw).epoch(0))
    _equal(list(ManifestLoader(corpus["csv"]["plain"], num_workers=1, host_shard=(0, 1), native=False,
                               **kw).epoch(0)), one)
    _equal(one, _jax_batches(corpus["csv"]["plain"], False, monkeypatch, host_shard=(0, 1), **kw))


@pytest.mark.parametrize("use_native", [False, True])
def test_a_sharded_loader_resumes_mid_epoch(corpus, use_native):
    loader = ManifestLoader(corpus["csv"]["plain"], 2, CLIP, SR, seed=2, num_workers=2, host_shard=(1, 2),
                            native=use_native)
    full = list(loader.epoch(0))
    it = loader.epoch(0)
    next(it)
    pos = dict(loader.position)
    it.close()
    rest = list(loader.epoch(0, pos["batch"], pos["rng"]))
    _equal(rest, full[1:])


# ---------------------------------------------------------------- tar shards


def test_write_shards_and_the_cli_match_jax(corpus, tmp_path):
    want = jtar.write_shards(corpus["files"], str(tmp_path / "jax"), shard_clips=5)
    strip = lambda e, root: os.path.relpath(e, root)  # noqa: E731
    assert [strip(e, corpus["root"] / "shards") for e in corpus["entries"]] == \
        [strip(e, tmp_path / "jax") for e in want]
    for entry in corpus["entries"][::4]:
        np.testing.assert_array_equal(np.frombuffer(tar.read_entry_bytes(entry), np.uint8),
                                      np.frombuffer(jtar.read_entry_bytes(entry), np.uint8))
    assert tar.resolve_ranges(corpus["entries"] + corpus["files"][:1]) == \
        jtar.resolve_ranges(corpus["entries"] + corpus["files"][:1])
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "audiossl_tpu_torch.data.tar", corpus["csv"]["plain"],
                          str(tmp_path / "cli"), "--shard-clips", "6"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    rows = pd.read_csv(out.stdout.strip().splitlines()[-1])["files"].tolist()
    assert len(rows) == 13 and len({r.split("::")[0] for r in rows}) == 3


@pytest.mark.parametrize("kind", ["members", "bare", "labelled"])
def test_tar_rows_give_the_jax_loaders_batches(corpus, monkeypatch, kind):
    """Member rows, bare .tar rows (expanded in archive order) and labelled
    member rows: the files, the label ids and every batch equal JAX's, and
    the sharded manifest's batches equal the plain manifest's."""
    labeled = kind == "labelled"
    kw = dict(batch_size=B, clip_samples=CLIP, sample_rate=SR, seed=4, labeled=labeled)
    got_loader = ManifestLoader(corpus["csv"][kind], num_workers=2, native=False, **kw)
    ref_loader = JaxManifestLoader(corpus["csv"][kind], num_workers=1, **kw)
    assert got_loader.files == ref_loader.files == corpus["entries"]
    got = list(got_loader.epoch(1))
    _equal(got, _jax_batches(corpus["csv"][kind], False, monkeypatch, epoch=1, **kw))
    plain = list(ManifestLoader(corpus["csv"]["plain"], num_workers=1, batch_size=B, clip_samples=CLIP,
                                sample_rate=SR, seed=4, native=False).epoch(1))
    for (a, _), (b, _) in zip(got, plain):
        np.testing.assert_array_equal(a, b)


def test_bare_tar_rows_in_a_labelled_manifest_are_refused_as_in_jax(corpus, tmp_path):
    csv = str(tmp_path / "bad.csv")
    pd.DataFrame({"files": pd.read_csv(corpus["csv"]["bare"])["files"], "label": ["a", "b", "c"]}).to_csv(csv,
                                                                                                         index=False)
    with pytest.raises(ValueError) as want:
        JaxManifestLoader(csv, B, CLIP, SR, labeled=True)
    with pytest.raises(ValueError) as got:
        ManifestLoader(csv, B, CLIP, SR, labeled=True)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("use_native", [False, True])
def test_a_missing_member_follows_on_error(corpus, tmp_path, monkeypatch, use_native):
    """A member the shard does not hold: silence under on_error='zeros' (the
    JAX loader's batch exactly, on either path), an error under 'raise'."""
    rows = corpus["entries"][:5] + [corpus["entries"][0].split("::")[0] + "::nope.wav"]
    csv = str(tmp_path / "missing.csv")
    pd.DataFrame({"files": rows}).to_csv(csv, index=False)
    kw = dict(batch_size=6, clip_samples=CLIP, sample_rate=SR, shuffle=False, seed=1)
    got = list(ManifestLoader(csv, num_workers=1, on_error="zeros", native=use_native, **kw).epoch(0))
    _equal(got, _jax_batches(csv, use_native, monkeypatch, on_error="zeros", **kw))
    assert not got[0][0][5].any() and got[0][0][:5].any(axis=1).all()
    with pytest.raises((FileNotFoundError, IOError)):
        list(ManifestLoader(csv, num_workers=1, native=use_native, **kw).epoch(0))


# ---------------------------------------------------------------- the native loader


def _so_digest():
    path = os.path.join(ROOT, "audiossl_tpu", "data", "_native", "libwavloader.so")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_the_port_builds_its_own_library_and_leaves_the_jax_one_alone(tmp_path, monkeypatch):
    """A fresh build goes to the build directory, from csrc/wavloader.cpp,
    named by the source's hash; the JAX package's library (if one sits
    beside its source) keeps its bytes, and no file appears there."""
    before = _so_digest()
    jax_dir = os.listdir(os.path.join(ROOT, "audiossl_tpu", "data", "_native"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available()
    so = native.library_path()
    assert os.path.dirname(so) == str(tmp_path / "build") and os.path.exists(so)
    assert os.listdir(tmp_path / "build") == [os.path.basename(so)]
    assert _so_digest() == before
    assert os.listdir(os.path.join(ROOT, "audiossl_tpu", "data", "_native")) == jax_dir
    assert os.path.dirname(native._SRC) == os.path.join(ROOT, "audiossl_tpu_torch", "csrc")


def test_native_batches_equal_jax_native_and_numpy_batches(corpus, monkeypatch):
    """The port's native batches equal the JAX native loader's for a seed
    (sharded and not, plain files and tar ranges); its decode equals the
    NumPy decode; and where no clip is longer than the window (no crop draw)
    the native batches equal the NumPy path's of both packages."""
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain")
    kw = dict(batch_size=B, clip_samples=CLIP, sample_rate=SR, seed=9)
    for csv in (corpus["csv"]["plain"], corpus["csv"]["members"]):
        for shard in (None, (1, 2)):
            loader = ManifestLoader(csv, num_workers=2, native=True, host_shard=shard, **kw)
            assert loader.native
            _equal(list(loader.epoch(1)), _jax_batches(csv, True, monkeypatch, host_shard=shard, epoch=1, **kw))
    from audiossl_tpu_torch.data.wav import load_wave

    for f in corpus["files"][:3]:
        np.testing.assert_array_equal(native.decode(f), load_wave(f))
        np.testing.assert_array_equal(native.decode(f), jnative.decode(f))
    long = dict(kw, clip_samples=2 * CLIP)  # every clip shorter: symmetric zero padding, no draw
    got = list(ManifestLoader(corpus["csv"]["members"], num_workers=1, native=True, **long).epoch(0))
    _equal(got, list(ManifestLoader(corpus["csv"]["members"], num_workers=1, native=False, **long).epoch(0)))
    _equal(got, _jax_batches(corpus["csv"]["members"], False, monkeypatch, **long))


def test_the_default_loader_takes_the_native_path(corpus, caplog):
    """As in JAX, a loader decodes natively wherever the library builds,
    with no option set, and logs it; ``native=False`` asks for NumPy."""
    if not native.available():
        pytest.skip("no C++ toolchain")
    with caplog.at_level("INFO", logger="audiossl_tpu_torch.data"):
        assert ManifestLoader(corpus["csv"]["plain"], B, CLIP, SR).native
        assert "native C++ decode" in caplog.text
        assert not ManifestLoader(corpus["csv"]["plain"], B, CLIP, SR, native=False).native
        assert "NumPy decode (asked)" in caplog.text


def test_the_loader_says_which_path_it_took(corpus, monkeypatch, caplog):
    """Without a library a loader falls back to NumPy, logs it and says
    so (``loader.native``), with the NumPy path's batches."""
    monkeypatch.setattr(native, "available", lambda: False)
    with caplog.at_level("INFO", logger="audiossl_tpu_torch.data"):
        loader = ManifestLoader(corpus["csv"]["plain"], B, CLIP, SR, seed=2, num_workers=1)
    assert not loader.native and "the native library is unavailable; NumPy decode" in caplog.text
    _equal(list(loader.epoch(0)), list(ManifestLoader(corpus["csv"]["plain"], B, CLIP, SR, seed=2,
                                                      num_workers=1, native=False).epoch(0)))
