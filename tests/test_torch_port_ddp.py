"""Data parallelism across processes on the CPU: two gloo ranks of the port
(one ``torch.multiprocessing.spawn`` for every check, tests/torch_ddp_worker.py)
against the JAX package's step on a 2-device ``data`` mesh (2 of the 8 host
devices tests/conftest.py forces, ``shard_map`` with ``check_vma=False`` as
the JAX trainers run it), and against the port's own one-process run of the
whole batch. f32, dropout and drop path 0; inputs are numpy from a seed.

Tolerances, each relative to max(1, max|ref|) unless said otherwise:
* block 1 (SyncBN, plain versions): forward and statistics 1e-5, gradients
  2e-4 absolute + 1e-4 relative (tests/test_torch_port_block1.py's bounds);
* Barlow: loss 1e-5 relative, the weight's gradient 1e-4 of its max;
* DeLoRes-S, one SGD step: every parameter and running statistic within
  1e-5 of JAX's (lr 0.03 times the single-process test's gradient bound);
* DeLoRes-M and SS-MAST (shuffle-BN on and off): the queue 1e-5 (unit keys
  out of f32 encoders), the pointer exact, the key BN statistics 1e-5;
* the fine-tune and the probe, world 2 x B/2 against world 1 x B: the loss
  1e-5 relative, every gradient 1e-4 of its max + 1e-6 of the largest
  (sums in another order), and both replicas' parameters bit-identical
  after the optimizer step.
"""
import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from audiossl_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from audiossl_tpu.data.augment import AugmentPipeline as JaxAugmentPipeline
from audiossl_tpu.models import heads as jheads
from audiossl_tpu.models import mast as jmast
from audiossl_tpu.models import mvit as jmvit
from audiossl_tpu.objectives.decar import kmeans_on_mesh as jax_kmeans_on_mesh
from audiossl_tpu.objectives.delores_m import DeloresM as JaxDeloresM
from audiossl_tpu.objectives.delores_s import DeloresS as JaxDeloresS
from audiossl_tpu.objectives.ssmast import SSMast as JaxSSMast
from audiossl_tpu.ops.block1 import block1_batch_stats, block1_streams, fused_block1 as jax_fused_block1
from audiossl_tpu.train import optim as joptim
from audiossl_tpu_torch.models import mast as pmast
from audiossl_tpu_torch.models.convert import (aug_state_from_flax, aug_state_to_flax, audiontt_from_flax,
                                               delores_m_from_flax, mast_with_head_from_flax, projection_from_flax)
from audiossl_tpu_torch.models.mvit import MViTConfig
from audiossl_tpu_torch.parallel import dist, launch
from audiossl_tpu_torch.train.loop import check_parallel_knobs, check_world_size, global_batch, join_group
from tests import torch_ddp_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
C, F_, T_ = 64, 8, 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def short_tiny():
    """MAST tiny with 4 blocks on both sides (the spawned ranks cut theirs)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jmast.VARIANTS, "tiny", lambda **kw: jmvit.MViTConfig._variant(4, 0.1, (1, 2, 3), kw))
        mp.setitem(pmast.VARIANTS, "tiny", lambda **kw: MViTConfig._variant(4, 0.1, (1, 2, 3), kw))
        yield


def _mesh():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))


def _smap(fn, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=_mesh(), in_specs=in_specs, out_specs=out_specs, check_vma=False))


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max()) if want.size else 1.0), (what, err)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _cfg(name, **pre):
    with open(os.path.join(ROOT, "configs", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    for k, v in pre.items():
        cfg["pretrain"][k] = v
    return cfg


def _perturb(tree, seed):
    """Random biases, BN affines and running statistics (var > 0) around the init."""
    rng = np.random.default_rng(seed)

    def f(path, v):
        v = np.asarray(v)
        key = jax.tree_util.keystr(path)
        if "'kernel'" in key or v.dtype.kind != "f":
            return v
        if "'var'" in key:
            return (0.5 + rng.random(v.shape)).astype(np.float32)
        return (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, tree)


# ---------------------------------------------------------------- inputs


def _delores_s_inputs():
    cfg = _cfg("delores_s", projection_dim=32)
    cfg["pretrain"]["base_encoder"].update(output_dim=32, compute_dtype="float32", dropout=0.0)
    jobj = JaxDeloresS(cfg, axis_name="data")
    dummy = jnp.zeros((4, 64, 96, 1), jnp.float32)
    params, bs, _ = jax.jit(jobj.init)(jax.random.key(0), (dummy, dummy))
    params, bs = _perturb(params, 1), _np_tree(bs)
    rng = np.random.default_rng(2)
    v1, v2 = ((1.5 * rng.standard_normal((8, 1, 64, 96))).astype(np.float32) for _ in range(2))
    return cfg, jobj, params, bs, v1, v2


def _port_delores_s_state(params, bs):
    sd = {f"encoder.{k}": v for k, v in audiontt_from_flax({"params": params["encoder"],
                                                             "batch_stats": bs["encoder"]}).items()}
    sd.update({f"projector.{k}": v for k, v in projection_from_flax(params["projector"], bs["projector"]).items()})
    return sd


@functools.lru_cache(maxsize=1)
def _delores_m_init():
    """One initialisation for both shuffle modes (shuffle_bn adds no state)."""
    cfg = _cfg("delores_m", num_negatives=16)
    cfg["pretrain"]["base_encoder"].update(output_dim=32, compute_dtype="float32", dropout=0.0)
    rng = np.random.default_rng(3)
    v1, v2 = ((1.5 * rng.standard_normal((4, 1, 64, 96))).astype(np.float32) for _ in range(2))
    nhwc = lambda v: jnp.asarray(v.transpose(0, 2, 3, 1))  # noqa: E731
    params, bs, ssl = jax.jit(JaxDeloresM(cfg, axis_name="data").init)(jax.random.key(0), (nhwc(v1[:2]),
                                                                                          nhwc(v2[:2])))
    params, bs = _perturb(params, 4), _perturb(bs, 5)
    ssl = ssl._replace(params_k=params["encoder"], batch_stats_k=bs["encoder"])
    return cfg, params, bs, _np_tree(ssl), v1, v2


def _delores_m_inputs(shuffle):
    cfg, params, bs, ssl, v1, v2 = _delores_m_init()
    cfg = copy.deepcopy(cfg)
    cfg["pretrain"]["shuffle_bn"] = shuffle
    return cfg, JaxDeloresM(cfg, axis_name="data"), params, bs, ssl, v1, v2


def _ssmast_cfg():
    cfg = _cfg("ssmast", model_size="tiny", num_negatives=64, contrastive_dim=16, droppath_rate=0.0,
               compute_dtype="f32", steps_per_epoch=2, shuffle_bn=True, fused_attention="off")
    cfg["pretrain"]["input"].update(n_mels=64, target_length=96)
    return cfg


def _ssmast_inputs():
    cfg = _ssmast_cfg()
    jobj = JaxSSMast(cfg, axis_name="data")
    rng = np.random.default_rng(6)
    v1, v2 = (rng.standard_normal((4, 1, 64, 96)).astype(np.float32) for _ in range(2))
    nhwc = lambda v: jnp.asarray(v.transpose(0, 2, 3, 1))  # noqa: E731
    params, bs, ssl = jax.jit(jobj.init)(jax.random.key(0), (nhwc(v1[:2]), nhwc(v2[:2])))
    return cfg, jobj, _np_tree(params), bs, _np_tree(ssl), v1, v2


FT = {"model_size": "tiny", "freqm": 0, "timem": 0, "compute_dtype": "f32", "droppath_rate": 0.0,
      "norm_stats": {"mean": -13.9, "std": 5.3},
      "input": {"type": "fbank", "sampling_rate": 16000, "length_wave": 0.5, "n_mels": 64, "target_length": 48,
                "mixup": 0.0, "noise": False}}


def _finetune_inputs():
    from audiossl_tpu_torch.train import finetune_mast as ft

    model = ft.init_classifier(FT, 5, seed=3, device="cpu")
    rng = np.random.default_rng(7)
    waves = (0.3 * rng.standard_normal((4, 8000))).astype(np.float32)
    targets = (rng.random((4, 5)) < 0.4).astype(np.float32)
    return {"ft": FT, "n_classes": 5, "state": {k: v.numpy() for k, v in model.state_dict().items()},
            "waves": waves, "targets": targets}


def _probe_inputs():
    from audiossl_tpu_torch.downstream.model import DownstreamModel
    from audiossl_tpu_torch.models.audiontt import random_state_dict

    model = DownstreamModel(n_mels=64, d=32, num_classes=3, dropout_rate=0.0, compute_dtype=torch.float32)
    sd = model.state_dict()
    sd.update({f"encoder.{k}": v for k, v in random_state_dict(64, 32, seed=8).items()})
    rng = np.random.default_rng(9)
    sd["final.weight"] = torch.from_numpy((0.1 * rng.standard_normal((3, 32))).astype(np.float32))
    waves = (0.3 * rng.standard_normal((8, 15200))).astype(np.float32)  # 96 frames: block 1 fused
    return {"state": {k: v.numpy() for k, v in sd.items()}, "waves": waves, "labels": np.arange(8) % 3}


@functools.lru_cache(maxsize=1)
def _inputs():
    rng = np.random.default_rng(0)
    kernel = (0.3 * rng.standard_normal((3, 3, 1, C))).astype(np.float32)
    b1 = {"x": rng.standard_normal((4, F_, T_)).astype(np.float32), "kernel": kernel,
          "w": np.ascontiguousarray(kernel.transpose(3, 2, 1, 0)),
          "bias": (0.1 * rng.standard_normal(C)).astype(np.float32),
          "gamma": (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32),
          "beta": (0.1 * rng.standard_normal(C)).astype(np.float32),
          "cot": rng.standard_normal((4, C, F_ // 2, T_ // 2)).astype(np.float32)}
    barlow = {"h1": rng.standard_normal((8, 16)).astype(np.float32),
              "h2": rng.standard_normal((8, 16)).astype(np.float32),
              "w": (0.3 * rng.standard_normal((16, 12))).astype(np.float32)}
    cfg, _, params, bs, v1, v2 = _delores_s_inputs()
    inputs = {"block1": b1, "barlow": barlow,
              "delores_s": {"name": "delores_s", "config": cfg, "state": _port_delores_s_state(params, bs),
                            "v1": v1, "v2": v2}}
    for name, shuffle in (("delores_m", False), ("delores_m_shuffle", True)):
        cfg, _, params, bs, ssl, v1, v2 = _delores_m_inputs(shuffle)
        inputs[name] = {"name": "delores_m", "config": cfg, "state": delores_m_from_flax(params, _np_tree(bs), ssl),
                        "v1": v1, "v2": v2}
    cfg, _, params, _, ssl, v1, v2 = _ssmast_inputs()
    state = {f"encoder.{k}": v for k, v in mast_with_head_from_flax(params["encoder"]).items()}
    state.update({f"encoder_k.{k}": v for k, v in mast_with_head_from_flax(ssl.params_k).items()})
    state.update(queue=torch.from_numpy(np.array(ssl.queue)), queue_ptr=torch.tensor(0), step=torch.tensor(0))
    inputs["ssmast_shuffle"] = {"name": "ssmast", "config": cfg, "state": state, "v1": v1, "v2": v2}
    inputs["finetune"], inputs["probe"], inputs["state"] = _finetune_inputs(), _probe_inputs(), {}
    inputs["kmeans"] = _kmeans_inputs()
    inputs["trainers"] = _trainer_inputs()
    inputs["eval"] = _eval_inputs()
    inputs["aug"] = {"epoch_samples": AUG_EPOCH, "augment": aug_state_from_flax(_jax_aug_state()),
                     "lms": np.random.default_rng(12).standard_normal((4, 1, 8, 12)).astype(np.float32)}
    return inputs


AUG_EPOCH = 20


def _jax_aug_config():
    return JaxAugmentConfig(mixup_ratio=None, rrc=False)


@functools.lru_cache(maxsize=1)
def _jax_aug_state():
    """JAX's world-sized aug state for 2 devices (RunningNorm only), each
    device's running moments and count different, as after some steps."""
    local = JaxAugmentPipeline(_jax_aug_config(), epoch_samples=AUG_EPOCH).init_state(8, 12)
    rn = local.running_norm
    return local._replace(running_norm=rn._replace(
        n=np.asarray([3, 7], np.int32), mean=np.asarray([0.1, -0.2], np.float32),
        var=np.asarray([1.5, 0.8], np.float32), max_update=np.full(2, np.asarray(rn.max_update), np.int32)))


@functools.lru_cache(maxsize=1)
def _eval_inputs():
    """5 eval clips in an AudioSet-style JSON (odd: a world of 2 wraps one)
    for the fine-tune's weights, and 7 labelled clips (a ragged last batch
    of 3) for the probe's; with them 8 training clips of each kind."""
    import json

    from audiossl_tpu_torch.data.wav import write_wav

    root = _workdir()
    rng = np.random.default_rng(11)
    clips = []
    for i in range(5):
        clips.append(os.path.join(root, f"e{i}.wav"))
        write_wav(clips[-1], (0.3 * rng.standard_normal(8000)).astype(np.float32))
    label_csv = os.path.join(root, "labels.csv")
    with open(label_csv, "w") as f:
        f.write("index,mid,display_name\n" + "".join(f"{c},/m/{c},c{c}\n" for c in range(5)))
    for name, n in (("eval", 5), ("train", 8)):
        data = {"data": [{"wav": clips[i % 5], "labels": f"/m/{i % 5},/m/{(i + 2) % 5}"} for i in range(n)]}
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(data, f)
    csvs = {}
    for name, n in (("probe", 7), ("probe_train", 8)):
        csvs[name] = os.path.join(root, f"{name}.csv")
        with open(csvs[name], "w") as f:
            f.write("wav,label\n")
            for i in range(n):
                p = os.path.join(root, f"{name}{i}.wav")
                write_wav(p, (0.3 * rng.standard_normal(15200)).astype(np.float32))
                f.write(f"{p},{'abc'[i % 3]}\n")
    return {"ft": FT, "n_classes": 5, "ft_state": _finetune_inputs()["state"], "json": os.path.join(root, "eval.json"),
            "train_json": os.path.join(root, "train.json"), "label_csv": label_csv,
            "probe_state": _probe_inputs()["state"], "probe_csv": csvs["probe"], "probe_train_csv": csvs["probe_train"]}


TRAINERS = {"delores_s": {}, "decar_v2": {"feat_dim": 8, "nmb_prototypes": [4], "freeze_prototypes_niters": 1},
            "decar_v1": {"num_clusters": 3}}


@functools.lru_cache(maxsize=1)
def _trainer_inputs():
    """16 distinct 1 s clips; per pretraining trainer a copy of its config at
    d = 32, a global batch of 4, 2 epochs, 3 steps; the fine-tune (MAST tiny,
    0.5 s clips, 2 steps and an eval of 5 clips) and the probe (d = 32, an
    epoch of 2 steps and a test of 7 clips); each at world 2."""
    from audiossl_tpu_torch.data.wav import write_wav

    root = _workdir()
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000.0
    files = []
    for i in range(16):
        f0 = rng.uniform(80.0, 800.0)
        files.append(os.path.join(root, f"c{i}.wav"))
        write_wav(files[-1], (0.4 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal(t.size)).astype(np.float32))
    csv = os.path.join(root, "clips.csv")
    with open(csv, "w") as f:
        f.write("files\n" + "".join(f"{p}\n" for p in files))

    def dump(name, cfg):
        path = os.path.join(root, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    runs, saves = [], {}
    for name, pre in TRAINERS.items():
        cfg = _cfg(name, **pre)
        cfg["pretrain"]["base_encoder"]["output_dim"] = 32
        if name == "delores_s":
            cfg["pretrain"]["projection_dim"] = 32
        cfg["run"].update(batch_size=4, epochs=2, num_dataloader_workers=1, log_every=1, world_size=2)
        saves[name] = os.path.join(root, name)
        runs.append((name, "audiossl_tpu_torch.train_upstream",
                     ["--upstream", name, "--input", csv, "-c", dump(name, cfg), "--device", "cpu", "--save_path",
                      saves[name], "--max_steps", "3"]))
    with open(os.path.join(ROOT, "configs", "mast_ft.yaml")) as f:
        ft = yaml.safe_load(f)
    ft["finetune"].update(model_size="tiny")
    ft["finetune"]["input"].update(n_mels=64, target_length=48, length_wave=0.5)
    ft["run"].update(batch_size=4, epochs=1, num_dataloader_workers=1, log_every=1, world_size=2)
    ev = _eval_inputs()
    saves["finetune"] = os.path.join(root, "finetune")
    runs.append(("finetune", "audiossl_tpu_torch.train.finetune_mast",
                 ["--train_json", ev["train_json"], "--label_csv", ev["label_csv"], "--eval_json", ev["json"], "-c",
                  dump("finetune", ft), "--device", "cpu", "--save_path", saves["finetune"], "--max_steps", "2"]))
    with open(os.path.join(ROOT, "configs", "downstream.yaml")) as f:
        ds = yaml.safe_load(f)
    ds["downstream"]["base_encoder"]["output_dim"] = 32
    ds["run"].update(batch_size=4, epochs=1, num_dataloader_workers=1, world_size=2)
    saves["probe"] = os.path.join(root, "probe")
    runs.append(("probe", "audiossl_tpu_torch.train_downstream",
                 ["--train_csv", ev["probe_train_csv"], "--test_csv", ev["probe_csv"], "-c", dump("probe", ds),
                  "--device", "cpu", "--exp_dir", saves["probe"], "--task", "t"]))
    return {"csv": csv, "runs": runs, "saves": saves}


@functools.lru_cache(maxsize=1)
def _workdir():
    """A directory for the trainers' clips and runs, removed at exit."""
    import atexit
    import shutil
    import tempfile

    path = tempfile.mkdtemp(prefix="ddp_trainers_")
    atexit.register(shutil.rmtree, path, True)
    return path


KM_SHARD, KM_K = 24, 5


def _kmeans_inputs():
    """Two bank shards of 24 unit embeddings around 5 directions, 4 slots of
    each unfilled (-1), over 40 clips; JAX's initial pick from its key."""
    rng = np.random.default_rng(10)
    centers = rng.standard_normal((KM_K, 8))
    emb = centers[rng.integers(0, KM_K, 2 * KM_SHARD)] + 0.3 * rng.standard_normal((2 * KM_SHARD, 8))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    idx = rng.permutation(40)[:2 * KM_SHARD - 8].tolist()
    idx = np.asarray(idx[:20] + [-1] * 4 + idx[20:] + [-1] * 4, np.int64)
    pick = np.asarray(jax.random.permutation(jax.random.key(3), KM_SHARD)[:KM_K])
    return {"emb": emb, "idx": idx, "n_total": 40, "k": KM_K, "pick": pick, "iters": 10}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both gloo ranks' results of every check (one spawn); while they run,
    this process makes the JAX references and its own one-process runs."""
    d = tmp_path_factory.mktemp("ddp")
    torch.save(_inputs(), str(d / "inputs.pt"))
    env = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",)}
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        ctx = torch.multiprocessing.spawn(worker.run, args=(WORLD, f"file://{d / 'rendezvous'}", str(d / "inputs.pt"), str(d)),
                                          nprocs=WORLD, join=False)
    finally:
        for k, v in env.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
    try:
        _jax_block1(), _jax_delores_s_step()
        for name in ("delores_m", "delores_m_shuffle", "ssmast_shuffle"):
            _jax_moco(name)
        for name in ("block1", "barlow", "finetune", "probe", "eval"):
            _one_process(name)
    finally:
        while not ctx.join():
            pass
    return [torch.load(str(d / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]


@functools.lru_cache(maxsize=None)
def _one_process(name):
    """The port's one-process result of a check at the whole batch."""
    assert not dist.active()
    return worker.CHECKS[name](copy.deepcopy(_inputs()[name]))


def _cat(ranks, name, key):
    return np.concatenate([r[name][key] for r in ranks])


def _replicas_equal(ranks, name, key="state"):
    for k, v in ranks[0][name][key].items():
        np.testing.assert_array_equal(v, ranks[1][name][key][k], err_msg=k)


# ---------------------------------------------------------------- block 1 and the Barlow loss


@functools.lru_cache(maxsize=1)
def _jax_block1():
    d = _inputs()["block1"]

    def local(x, cot, k, bi, g, be):
        b, f, t = x.shape

        def loss(k, bi, g, be):
            xe, xo, nv = block1_streams(jnp.transpose(x, (0, 2, 1)), 128)
            mean, var = block1_batch_stats(xe, xo, nv, k, bi, f, "data", interpret=True)
            out = jax_fused_block1(xe, xo, nv, k, bi, g, be, mean, var, f, True, "data", 128, True)
            pooled = jnp.transpose(out.reshape(b, t // 2, f // 2, C), (0, 3, 2, 1))
            return jnp.sum(pooled * cot) / b, (pooled, mean, var)

        (_, aux), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(k, bi, g, be)
        return aux, jax.lax.pmean(grads, "data")

    fn = _smap(local, (P("data"), P("data"), P(), P(), P(), P()), ((P("data"), P(), P()), P()))
    (pooled, mean, var), grads = fn(*(jnp.asarray(d[k]) for k in ("x", "cot", "kernel", "bias", "gamma", "beta")))
    dk = np.asarray(grads[0]).transpose(3, 2, 1, 0)  # flax HWIO -> [C, 1, F, T]
    return {"pooled": np.asarray(pooled), "mean": np.asarray(mean), "var": np.asarray(var), "dw": dk,
            "dbias": np.asarray(grads[1]), "dgamma": np.asarray(grads[2]), "dbeta": np.asarray(grads[3])}


@pytest.mark.parametrize("ref", ["jax_2_devices", "port_1_process"])
def test_syncbn_block1_forward_and_backward(ranks, ref):
    """Each rank sees 2 of the 4 clips; the pooled output, the group's batch
    statistics and the mean of the gradients equal JAX's fused_block1 under
    shard_map with axis_name (interpret mode) and the port's one process on
    all 4 clips; one all-reduce in the forward and one in the backward."""
    want = _jax_block1() if ref == "jax_2_devices" else _one_process("block1")
    _close(_cat(ranks, "block1", "pooled"), want["pooled"], 1e-5, "pooled")
    for r in ranks:
        for k in ("mean", "var"):
            _close(r["block1"][k], want[k], 1e-5, k)
        for k in ("dw", "dbias", "dgamma", "dbeta"):
            np.testing.assert_allclose(r["block1"][k], want[k], atol=2e-4, rtol=1e-4, err_msg=k)
        assert r["block1"]["calls"] == {"syncbn": 2, "all_reduce_grads": 1}


@pytest.mark.parametrize("ref", ["jax_2_devices", "port_1_process"])
def test_barlow_gradient_through_the_all_reduced_cross_correlation(ranks, ref):
    """The loss of the group's cross-correlation and the mean of the weight's
    gradients: JAX's psum with check_vma=False and the port's summed
    backward give the one-device gradient of the whole batch."""
    if ref == "jax_2_devices":
        d = _inputs()["barlow"]

        def local(h1, h2, w):
            loss, g = jax.value_and_grad(lambda w: jheads.barlow_loss(h1 @ w, h2 @ w, axis_name="data"))(w)
            return loss, jax.lax.pmean(g, "data")

        loss, dw = _smap(local, (P("data"), P("data"), P()), (P(), P()))(*(jnp.asarray(d[k]) for k in ("h1", "h2", "w")))
        want = {"loss": np.asarray(loss), "dw": np.asarray(dw)}
    else:
        want = _one_process("barlow")
    for r in ranks:
        assert abs(float(r["barlow"]["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
        _close(r["barlow"]["dw"], want["dw"], 1e-4, "dw")
        assert r["barlow"]["calls"] == {"barlow": 6, "all_reduce_grads": 1}  # 2 moments + c, each forward and back


# ---------------------------------------------------------------- a DeLoRes-S step


@functools.lru_cache(maxsize=1)
def _jax_delores_s_step():
    cfg, jobj, params, bs, v1, v2 = _delores_s_inputs()
    tx = joptim.sgd_torch(0.03)

    def local(p, v1, v2):
        def loss_fn(q):
            return jobj.loss(q, bs, (), (v1, v2), jax.random.key(1), True, "data")

        (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        g = jax.lax.pmean(g, "data")
        updates, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, updates), aux.batch_stats, jax.lax.pmean(loss, "data")

    nhwc = lambda v: jnp.asarray(v.transpose(0, 2, 3, 1))  # noqa: E731
    new_p, new_bs, loss = _smap(local, (P(), P("data"), P("data")), (P(), P(), P()))(params, nhwc(v1), nhwc(v2))
    return _port_delores_s_state(_np_tree(new_p), _np_tree(new_bs)), float(loss)


def test_delores_s_step_matches_the_jax_data_mesh(ranks):
    """One SGD step of DeLoRes-S (d = 32) on 8 clips, 4 a rank: TrainStep's
    all-reduced gradients and loss; SyncBN in block 1, blocks 2-3 and the
    projector; the Barlow all-reduce. Every parameter and running statistic
    after the step within 1e-5 of JAX's 2-device step; the replicas equal."""
    want, loss = _jax_delores_s_step()
    for r in ranks:
        assert abs(float(r["delores_s"]["loss"]) - loss) <= 1e-5 * abs(loss)
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                _close(r["delores_s"]["state"][k], v.numpy(), 1e-5, k)
    _replicas_equal(ranks, "delores_s")
    calls = ranks[0]["delores_s"]["calls"]
    # 2 views x (block 1: 1 + 1; blocks 2-3: 2 x 2; projector BNs: 2 x 2), the Barlow loss's 6,
    # the gradients' 1 and the loss's 1
    assert calls == {"syncbn": 20, "barlow": 6, "all_reduce_grads": 1, "all_reduce": 1}, calls


# ---------------------------------------------------------------- the MoCo queues and shuffle-BN


@functools.lru_cache(maxsize=None)
def _jax_moco(name):
    if name == "ssmast_shuffle":
        cfg, jobj, params, bs, ssl, v1, v2 = _ssmast_inputs()
    else:
        cfg, jobj, params, bs, ssl, v1, v2 = _delores_m_inputs(name == "delores_m_shuffle")

    def local(p, s, v1, v2):
        loss, aux = jobj.loss(p, bs, s, (v1, v2), jax.random.key(1), True, "data")
        return jax.lax.pmean(loss, "data"), aux.ssl_state

    nhwc = lambda v: jnp.asarray(v.transpose(0, 2, 3, 1))  # noqa: E731
    loss, ssl = _smap(local, (P(), P(), P("data"), P("data")), (P(), P()))(params, ssl, nhwc(v1), nhwc(v2))
    return float(loss), _np_tree(ssl)


@pytest.mark.parametrize("name", ["delores_m", "delores_m_shuffle", "ssmast_shuffle"])
def test_moco_queue_and_shuffle_bn_match_the_jax_data_mesh(ranks, name):
    """After one step on 4 clips (SS-MAST: sequential views)
    split over two ranks: the queue holds both ranks' keys in JAX's order
    (rank 0's, then rank 1's), the pointer moved by the global batch, the
    loss is the group's, and DeLoRes-M's key tower took SyncBN statistics.
    With shuffle-BN the key batch crossed ranks by rank 0's permutation and
    came back, so nothing changes numerically."""
    loss, ssl = _jax_moco(name)
    for r in ranks:
        out = r[name]
        assert abs(float(out["loss"]) - loss) <= 1e-5 * abs(loss), (out["loss"], loss)
        _close(out["queue"], ssl.queue, 1e-5, "queue")
        assert out["ptr"] == int(ssl.queue_ptr)
    np.testing.assert_array_equal(ranks[0][name]["queue"], ranks[1][name]["queue"])
    calls = ranks[0][name]["calls"]
    if name == "ssmast_shuffle":
        # two directions: a broadcast of the permutation, 2 gathers (shuffle, unshuffle), the enqueue's
        assert int(ssl.queue_ptr) == 8 and calls == {"broadcast": 2, "all_gather": 6, "all_reduce": 1}, calls
    else:
        assert int(ssl.queue_ptr) == 4
        ref = {f"encoder_k.encoder.{k}": v for k, v in audiontt_from_flax(
            {"params": ssl.params_k["encoder"], "batch_stats": ssl.batch_stats_k["encoder"]}).items() if "running" in k}
        for k, v in ref.items():
            _close(ranks[0][name]["key_state"][k], v.numpy(), 1e-5, k)
        gathers = 1 + (4 if name == "delores_m_shuffle" else 0)  # the enqueue; k and 3 taps unshuffled
        assert calls["all_gather"] == gathers + (name == "delores_m_shuffle"), calls


# ---------------------------------------------------------------- the fine-tune and the probe


@pytest.mark.parametrize("name", ["finetune", "probe"])
def test_world_2_step_equals_one_process_on_the_whole_batch(ranks, name):
    """Their collectives are the mean of the gradients and of the loss (and
    the probe's SyncBN): world 2 x B/2 against the port's world 1 x B."""
    want = _one_process(name)
    largest = max(float(np.abs(g).max()) for g in want["grads"].values())
    for r in ranks:
        assert abs(float(r[name]["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
        for k, g in want["grads"].items():
            bound = 1e-4 * float(np.abs(g).max()) + 1e-6 * largest
            assert float(np.abs(r[name]["grads"][k] - g).max()) <= bound, k
    _replicas_equal(ranks, name)
    assert ranks[0][name]["calls"]["all_reduce_grads"] == 1


def test_decar_kmeans_over_two_bank_shards_matches_jax(ranks):
    """One k-means pass of 10 iterations over two ranks' shards of the bank
    against JAX's kmeans_on_mesh under shard_map on 2 devices: the
    centroids within 1e-5 (f32 products, sums in another order) and every
    clip's assignment equal, -100 for the clips no slot holds."""
    d = _inputs()["kmeans"]

    def local(emb, idx):
        return jax_kmeans_on_mesh(emb, idx, d["n_total"], d["k"], jax.random.key(3), d["iters"], "data")

    cents, assign = _smap(local, (P("data"), P("data")), (P(), P()))(jnp.asarray(d["emb"]),
                                                                    jnp.asarray(d["idx"], jnp.int32))
    for r in ranks:
        _close(r["kmeans"]["cents"], cents, 1e-5, "centroids")
        np.testing.assert_array_equal(r["kmeans"]["assign"], np.asarray(assign))
        assert r["kmeans"]["calls"] == {"broadcast": 1, "kmeans": 2 * d["iters"], "all_gather": 2}
    assert (np.asarray(assign) == -100).sum() == 40 - (2 * KM_SHARD - 8)


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainers_run_at_world_2_and_refuse_another_world_on_resume(ranks, name):
    """train_upstream (DeLoRes-S), DECAR-v2 and DeepCluster-v1 through the CLI
    with run.world_size 2 on two gloo ranks, 2 clips a rank, 3 steps: finite
    losses in rank 0's stats; rank 0's checkpoint holds both ranks' generators
    (and DECAR's two bank shards, both augmentation states); resuming it in
    one process raises, as JAX's restore of a P(DATA_AXIS) state of another
    length does."""
    import json

    from audiossl_tpu_torch.train_upstream import main

    _, _, argv = next(r for r in _inputs()["trainers"]["runs"] if r[0] == name)
    save, steps = _inputs()["trainers"]["saves"][name], 3
    assert all(r["trainers"][name] for r in ranks)
    with open(os.path.join(save + "_chkp", "stats.jsonl")) as f:
        losses = [json.loads(line)["train_loss"] for line in f if "train_loss" in json.loads(line)]
    assert len(losses) == steps and np.isfinite(losses).all()
    state = torch.load(os.path.join(save + "_chkp", "state", f"{steps}.pt"), weights_only=True)
    assert len(state["generator"]) == 2
    if name != "decar_v1":
        assert state["augment"]["world"] == 2 and state["augment"]["running_norm"]["n"].shape == (2,)
    if name == "decar_v2":
        assert state["memory"]["index"].shape[0] == 2 and bool((state["memory"]["index"] >= 0).all())
    with pytest.raises(ValueError, match="2 process"):
        main(argv[:-4] + ["--save_path", save + "_again", "--load_checkpoint", save + "_chkp", "--max_steps", "4"])


def test_eval_paths_at_world_2(ranks):
    """The fine-tune's sharded eval gathers every score back into the
    datafile's order and drops the wrapped tail (5 clips at world 2: the
    first is read twice and counted once), each score within 1e-5 of one
    process's; the probe's test accuracy over every rank's share of each
    batch (7 clips, a ragged last batch) equals one process's."""
    want = _one_process("eval")
    for r in ranks:
        np.testing.assert_array_equal(r["eval"]["targets"], want["targets"])
        _close(r["eval"]["scores"], want["scores"], 1e-5, "scores")
        assert r["eval"]["accuracy"] == want["accuracy"]


def test_finetune_and_probe_clis_at_world_2(ranks):
    """The fine-tune (MAST tiny, host_shard loaders, 2 steps and a sharded
    eval) and the probe (every rank's share of each batch, SyncBN) through
    their CLIs at world 2: rank 0's stats hold finite losses and the eval
    metrics; the fine-tune's checkpoint both ranks' generators, and a
    one-process resume of it raises."""
    import json

    from audiossl_tpu_torch.train import finetune_mast as ft

    assert all(r["trainers"]["finetune"] and r["trainers"]["probe"] for r in ranks)
    saves = _inputs()["trainers"]["saves"]
    with open(os.path.join(saves["finetune"] + "_chkp", "stats.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    steps, epochs = [x for x in lines if "step" in x], [x for x in lines if "mAP" in x]
    assert len(steps) == 2 and np.isfinite([x["train_loss"] for x in steps]).all()
    assert len(epochs) == 1 and 0.0 <= epochs[0]["mAP"] <= 1.0 and 0.0 <= epochs[0]["AUC"] <= 1.0
    state = torch.load(os.path.join(saves["finetune"] + "_chkp", "state", "2.pt"), weights_only=True)
    assert len(state["generator"]) == len(state["loader_rngs"]) == 2
    argv = next(r for r in _inputs()["trainers"]["runs"] if r[0] == "finetune")[2]
    with pytest.raises(ValueError, match="2 process"):
        ft.main(argv[:-4] + ["--save_path", saves["finetune"] + "_again", "--load_checkpoint",
                             saves["finetune"] + "_chkp", "--max_steps", "3"])
    with open(os.path.join(saves["probe"], "t", "downstream_stats.txt")) as f:
        probe = [json.loads(line) for line in f]
    assert len(probe) == 1 and np.isfinite(probe[0]["Train_loss"]) and 0.0 <= probe[0]["Test_Accuracy"] <= 1.0


# ---------------------------------------------------------------- state, launcher and knobs


def test_preemption_and_the_world_sized_augmentation_state(ranks):
    """Rank 1's SIGTERM flag stops both ranks (one all-reduce); the
    augmentation state gathers into [world, ...] in rank order, and each
    rank reads its own row back."""
    for r in ranks:
        assert r["state"]["stop"] is True and r["state"]["row_back"]
    layout = ranks[0]["state"]["world_layout"]
    assert layout["world"] == 2 and layout["mixup"]["bank"].shape == (2, 3, 2, 2)
    assert layout["mixup"]["fill"].tolist() == [2, 3] and layout["running_norm"]["n"].tolist() == [10, 11]


def test_per_rank_aug_state_starts_both_sides_alike(ranks):
    """JAX's P(DATA_AXIS) aug state (two RunningNorm states) carried into the
    port's world-sized checkpoint layout (``aug_state_from_flax``): each rank
    normalises its clips from its own row as each JAX device does under
    shard_map, the views within 1e-5, and the states after, gathered back and
    carried to JAX's layout (``aug_state_to_flax``), equal JAX's (counts
    exactly, moments within 1e-6)."""
    pipe = JaxAugmentPipeline(_jax_aug_config(), epoch_samples=AUG_EPOCH)

    def local(state, x):
        s, v1, v2 = pipe(jax.tree.map(lambda a: a[0], state), x, jax.random.key(0))
        return jax.tree.map(lambda a: a[None], s), v1, v2

    state, v1, v2 = _smap(local, (P("data"), P("data")), (P("data"), P("data"), P("data")))(
        jax.tree.map(jnp.asarray, _jax_aug_state()), jnp.asarray(_inputs()["aug"]["lms"]))
    _close(np.concatenate([r["aug"]["v1"] for r in ranks]), v1, 1e-5, "v1")
    _close(np.concatenate([r["aug"]["v2"] for r in ranks]), v2, 1e-5, "v2")
    for r in ranks:
        back = aug_state_to_flax(r["aug"]["augment"])["running_norm"]
        for k in ("n", "max_update"):
            np.testing.assert_array_equal(back[k], np.asarray(getattr(state.running_norm, k)), err_msg=k)
        for k in ("mean", "var"):
            np.testing.assert_allclose(back[k], np.asarray(getattr(state.running_norm, k)), atol=1e-6, err_msg=k)


def test_aug_state_crosses_from_jax_and_back():
    """JAX's world-sized aug state (P(DATA_AXIS): the pipeline's init
    broadcast to 2 devices, then filled) -> the port's checkpoint layout -> back."""
    pipe = JaxAugmentPipeline(JaxAugmentConfig(), epoch_samples=16)
    local = pipe.init_state(8, 6)
    rng = np.random.default_rng(0)
    world = jax.tree.map(lambda a: np.broadcast_to(np.asarray(a)[None], (2,) + a.shape).copy(), local)
    world.mixup.bank[...] = rng.standard_normal(world.mixup.bank.shape).astype(world.mixup.bank.dtype)
    world.running_norm.n[...] = [5, 7]
    port = aug_state_from_flax(world)
    assert port["world"] == 2 and port["mixup"]["bank"].dtype == torch.bfloat16
    assert port["mixup"]["bank"].shape == (2, 16 * 0 + world.mixup.bank.shape[1], 8, 6)
    back = aug_state_to_flax(port)
    np.testing.assert_array_equal(back["mixup"]["bank"], np.asarray(world.mixup.bank, np.float32))
    for k in ("n", "mean", "var", "max_update"):
        np.testing.assert_array_equal(back["running_norm"][k], np.asarray(getattr(world.running_norm, k)))
    for k in ("fill", "ptr"):
        np.testing.assert_array_equal(back["mixup"][k], np.asarray(getattr(world.mixup, k)))


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"AUDIOSSL_COORDINATOR": "h0:1234", "AUDIOSSL_NUM_PROCESSES": "4", "AUDIOSSL_PROCESS_ID": "3"},
     {"init_method": "tcp://h0:1234", "world_size": 4, "rank": 3, "local_rank": 3, "source": "AUDIOSSL_* env"}),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_LOCALID": "1", "SLURM_JOB_NODELIST": "node[3-4],x"},
     {"init_method": "tcp://node3:12357", "world_size": 2, "rank": 1, "local_rank": 1, "source": "SLURM env"}),
    ({"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}, None),
    ({"RANK": "2", "WORLD_SIZE": "4", "LOCAL_RANK": "0", "MASTER_ADDR": "m", "MASTER_PORT": "29400"},
     {"init_method": "tcp://m:29400", "world_size": 4, "rank": 2, "local_rank": 0, "source": "torchrun env"}),
])
def test_launcher_env_parsing(env, want):
    assert launch.launch_env(env) == want
    if want is None:
        assert launch.maybe_init_distributed("cpu", env=env) is False


def test_backend_follows_the_device_and_no_group_is_world_one():
    assert launch.backend_for("cuda:1") == "nccl" and launch.backend_for("cpu") == "gloo"
    assert launch.process_info() == (0, 1) and dist.world() == 1 and dist.rank() == 0
    x = torch.randn(3, requires_grad=True)
    assert dist.all_reduce_sum(x) is x and dist.all_reduce_mean(x) is x and dist.all_gather(x) is x
    assert dist.broadcast_from(x) is x and dist.rank_seed(31) == 31 and dist.gather_objects(5) == [5]


def test_world_size_knob():
    """0 or absent: the group's size (1 here); 1: fine; any other value must
    equal the group's size; the batch rounds down to a multiple of the world."""
    assert check_world_size({}) == check_world_size({"world_size": 0}) == check_world_size({"world_size": 1}) == 1
    with pytest.raises(ValueError, match="world_size is 2 but the process group has 1"):
        check_world_size({"world_size": 2})
    with pytest.raises(NotImplementedError, match="run.zero_optimizer is run by train_upstream only"):
        check_parallel_knobs({"run": {"zero_optimizer": True, "world_size": 0}, "pretrain": {}})
    assert check_parallel_knobs({"run": {"zero_optimizer": True}, "pretrain": {}}, zero_runs=True) == 1
    tp_cfg = {"run": {"world_size": 0}, "pretrain": {"tp": 2, "base_encoder": {"type": "MAST"}}}
    assert check_parallel_knobs(tp_cfg, tp_runs=True) == 2 and check_parallel_knobs({"run": {}, "pretrain": {}}) == 1
    with pytest.raises(NotImplementedError, match="pretrain.tp > 1 is run by train_upstream"):
        check_parallel_knobs(tp_cfg)  # DECAR, DeepCluster, the fine-tune
    with pytest.raises(ValueError, match="1 devices not divisible by pretrain.tp=2"):
        join_group({"world_size": 0}, torch.device("cpu"), tp=2)
    with pytest.raises(ValueError, match="world_size is 3"):
        join_group({"world_size": 3}, torch.device("cpu"))  # no launcher in the environment: a world of 1
    assert global_batch(256, 2) == 256 and global_batch(7, 2) == 6 and global_batch(1, 2) == 2
