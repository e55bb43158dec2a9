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
    torch.backends.cudnn.allow_tf32 = False
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
        (LogMelConfig(n_fft=256, hop=64, n_mels=64), (3, 15200)),  # single-bin filters: the dense low bins
        (LogMelConfig(n_mels=128), (3, 15200)),  # two-bin filters
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


# ---------------------------------------------------------------- block 1

def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(v, 1e-30))) - 7)


def _block1_inputs(shape, dtype, device, seed=0, ties=False):
    """x [B, 1, F, T], params [64, 16] and dp for the block-1 kernels. With
    ``ties``, constant patches make exact positive ties inside windows and a
    third of the channels get a negative shift, so whole windows are ReLU zeros."""
    from audiossl_tpu_torch.ops import block1

    b, f, t = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 1, f, t)).astype(np.float32)
    if ties:
        x[:, :, : f // 2, : t // 2] = 0.75
    w = (0.3 * rng.standard_normal((64, 1, 3, 3))).astype(np.float32)
    vec = lambda s, o: torch.from_numpy((o + s * rng.standard_normal(64)).astype(np.float32))
    b2 = vec(0.3, 0.0)
    if ties:
        b2[::3] = -5.0
    params = block1.pack_params(
        torch.from_numpy(w), vec(0.1, 0.0), vec(0.2, 1.0), b2, vec(0.2, 1.0), vec(0.01, 0.0), vec(0.01, 0.0), dtype=dtype
    ).to(device)
    dp = rng.standard_normal((b, 64, f // 2, t // 2)).astype(np.float32)
    xt = torch.from_numpy(x).to(device=device, dtype=dtype)
    return xt, params, torch.from_numpy(dp).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,ties",
    [((3, 16, 20), False), ((2, 8, 12), True), ((4, 64, 96), False), ((2, 64, 96), True), ((2, 8, 2000), False),
     # pooled positions that fill neither a 16-position group nor an 8-row item
     ((3, 14, 22), False), ((3, 14, 22), True)],
)
def test_block1_kernels_match_plain(cuda, dtype, shape, ties):
    from audiossl_tpu_torch.ops import block1

    x, params, dp = _block1_inputs(shape, dtype, cuda, ties=ties)
    launches = (block1.block1_fwd.launches, block1.block1_bwd_sums.launches, block1.block1_bwd_weight.launches)
    got = [block1.block1_fwd(x, params), block1.block1_bwd_sums(x, dp, params), block1.block1_bwd_weight(x, dp, params)]
    want = [block1.block1_fwd_plain(x, params), block1.block1_bwd_sums_plain(x, dp, params),
            block1.block1_bwd_weight_plain(x, dp, params)]
    torch.cuda.synchronize()
    assert (block1.block1_fwd.launches, block1.block1_bwd_sums.launches, block1.block1_bwd_weight.launches) == tuple(
        n + 1 for n in launches
    )
    fwd, ref = got[0].float(), want[0].float()
    assert fwd.shape == ref.shape and fwd.dtype == ref.dtype and torch.isfinite(fwd).all()
    scale = float(ref.abs().max())
    tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else _bf16_ulp(scale)
    assert float((fwd - ref).abs().max()) <= tol
    for g, r in zip(got[1:], want[1:]):
        assert float((g - r).abs().max()) <= 1e-3 * float(r.abs().max())
    # deterministic: a second run gives the same bits
    assert torch.equal(block1.block1_fwd(x, params), got[0])
    assert torch.equal(block1.block1_bwd_sums(x, dp, params), got[1])
    assert torch.equal(block1.block1_bwd_weight(x, dp, params), got[2])


def test_block1_backward_above_48kb_of_shared_memory(cuda):
    """A long clip whose bf16 input tiles (two of up to 18 rows x 3004
    samples) take the tensor-core backward kernels past the default 48 KB of
    shared memory."""
    from audiossl_tpu_torch.ops import block1

    x, params, dp = _block1_inputs((2, 16, 3000), torch.bfloat16, cuda, seed=1)
    for kernel, plain in ((block1.block1_bwd_sums, block1.block1_bwd_sums_plain),
                          (block1.block1_bwd_weight, block1.block1_bwd_weight_plain)):
        got, want = kernel(x, dp, params), plain(x, dp, params)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
        assert torch.equal(kernel(x, dp, params), got)


def test_block1_forward_above_48kb_of_shared_memory(cuda):
    """The same long clip through the tensor-core forward, whose bf16 input
    tile (18 rows x 3004 samples) takes it past the default 48 KB."""
    from audiossl_tpu_torch.ops import block1

    x, params, _ = _block1_inputs((2, 16, 3000), torch.bfloat16, cuda, seed=1)
    got, want = block1.block1_fwd(x, params), block1.block1_fwd_plain(x, params)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype and torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= _bf16_ulp(float(want.float().abs().max()))


def test_block1_wrappers_reject_bad_inputs(cuda):
    from audiossl_tpu_torch.ops import block1

    x, params, dp = _block1_inputs((2, 8, 12), torch.float32, cuda)
    with pytest.raises(ValueError, match="F and T even"):
        block1.block1_fwd(x[..., :11].contiguous(), params)
    with pytest.raises(ValueError, match="contiguous"):
        block1.block1_fwd(x.transpose(2, 3), params)
    with pytest.raises(ValueError, match="dp must be"):
        block1.block1_bwd_sums(x, dp.to(torch.bfloat16), params)
    with pytest.raises(ValueError, match="64 channels"):  # the tensor-core kernels' one width
        block1.block1_bwd_weight(x.bfloat16(), dp[:, :32].bfloat16().contiguous(), params[:32].contiguous())
    with pytest.raises(ValueError, match="64 channels"):
        block1.block1_fwd(x.bfloat16(), params[:32].contiguous())
    narrow = params[:32].contiguous()  # f32 takes any width
    got, want = block1.block1_fwd(x, narrow), block1.block1_fwd_plain(x, narrow)
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


def test_fused_block1_autograd_on_the_card(cuda):
    """FusedBlock1 on the card against the same Function on the CPU (plain versions)."""
    from audiossl_tpu_torch.ops import block1

    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 1, 16, 20)).astype(np.float32)
    cot = rng.standard_normal((4, 64, 8, 10)).astype(np.float32)
    w = (0.3 * rng.standard_normal((64, 1, 3, 3))).astype(np.float32)
    vecs = [(o + 0.1 * rng.standard_normal(64)).astype(np.float32) for o in (0.0, 1.0, 0.0)]
    grads = []
    for dev in ("cpu", cuda):
        ps = [torch.from_numpy(p).to(dev).requires_grad_() for p in (w, *vecs)]
        out, mean, var = block1.fused_block1(torch.from_numpy(x).to(dev), *ps)
        (out * torch.from_numpy(cot).to(dev)).sum().backward()
        grads.append([out.detach().cpu(), mean.cpu(), var.cpu()] + [p.grad.cpu() for p in ps])
    for c, g in zip(*grads):
        assert float((c - g).abs().max()) <= 1e-3 * max(1.0, float(c.abs().max()))


# ---------------------------------------------------------------- DeLoRes-M, SLICER, UnFuSeD

# launches a step of log_mel_fused / block1_fwd / block1_bwd_sums / block1_bwd_weight (chip_smoke.TRAIN_LAUNCHES)
OBJECTIVE_LAUNCHES = {"delores_m": (1, 2, 1, 1), "slicer": (1, 4, 2, 2), "unfused": (1, 1, 1, 1)}


def _objective_config(name, dtype):
    import os

    import yaml

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"]["base_encoder"].update(output_dim=64, compute_dtype=dtype, dropout=0.0)
    cfg["pretrain"].update(num_negatives=64, contrastive_dim=16, instance_contrastive_dim=16, cluster_contrastive_dim=12,
                           task_label=7)
    return cfg


def objective_views(pre, k, b=8):
    """Batch ``k`` of ``b`` view pairs on the CPU, made as training makes
    them: sine-mixture waves (chip_smoke.sine_requests' recipe) through the
    log-mel, RunningNorm, mixup and crop, draws seeded by ``k``. Views of
    random normal values would not do: the 2048-wide Barlow heads
    standardise over 8 clips, and on such views the CPU alone, from weights
    nudged by 1e-7, moves the gradients past the gate's bounds in half the
    batches."""
    from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.train.step import prepare_views

    rng = np.random.default_rng(100 + k)
    t = np.arange(15200) / 16000.0
    f0 = 110.0 * 2 ** (rng.integers(0, 8, (b, 1)) / 2)
    waves = rng.uniform(0.2, 1.0, (b, 1)) * (0.5 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(2 * np.pi * 3.1 * f0 * t))
    waves = torch.from_numpy((waves + 0.01 * rng.standard_normal((b, 15200))).astype(np.float32))
    frontend = build_frontend(pre["input"])
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=10**6)
    n_frames = frontend.num_frames(15200)
    state = pipeline.init_state(frontend.n_mels, n_frames, "cpu")
    draws = pipeline.sample_draws(state, b, frontend.n_mels, n_frames, torch.Generator().manual_seed(k))
    return prepare_views(pipeline, frontend, "mean_var", state, waves, draws)[1:]


@pytest.mark.parametrize("name", sorted(OBJECTIVE_LAUNCHES))
def test_objective_f32_step_on_the_card_matches_cpu(cuda, name):
    """One f32 step of each objective (d = 64, a 64-key queue) on the card
    against the CPU from the same state, on 12 batches of B = 8 views
    (``objective_views``) and labels: the loss in every batch within 1e-5;
    chip_smoke.py's step-gate rule for the gradients (at least 6 batches
    with all gradients within 1e-3 in norm and each tensor within 1e-3 of
    its norm + 1e-3 of the largest: AudioNTT's f32 routing flips); the key
    encoder's parameters within 1e-6 and the queue and running statistics
    within 1e-3 of max(1, max|ref|), the pointer equal, in every batch."""
    import copy

    from audiossl_tpu_torch.objectives import init_objective

    cfg = _objective_config(name, "float32")
    init = init_objective(name, cfg, seed=0).train()
    rng = np.random.default_rng(4)
    passing, errors = 0, []  # per batch: all gradients in norm / the worst tensor in norm
    for k in range(12):
        v1, v2 = objective_views(cfg["pretrain"], k)
        labels = torch.from_numpy(rng.integers(0, 7, 8))
        out = []
        for dev in (cuda, torch.device("cpu")):
            obj = copy.deepcopy(init).to(dev)
            loss = obj.loss(v1.to(dev), v2.to(dev), labels=labels.to(dev))
            loss.backward()
            out.append((loss.item(), {n: p.grad.cpu() for n, p in obj.named_parameters() if p.requires_grad},
                        {n: v.cpu() for n, v in obj.state_dict().items()}))
        (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = out
        assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
        flat = lambda g: torch.cat([v.flatten() for v in g.values()])
        largest = max(float(v.norm()) for v in g_cpu.values())
        whole = float((flat(g_card) - flat(g_cpu)).norm() / flat(g_cpu).norm())
        each = max(float((g_card[n] - r).norm()) / (float(r.norm()) + 1e-3 * largest) for n, r in g_cpu.items())
        passing += whole <= 1e-3 and each <= 1e-3
        errors.append(f"{whole:.1e} / {each:.1e}")
        for n, r in s_cpu.items():
            if n.startswith("encoder_k.") and n[len("encoder_k."):] in dict(init.encoder_k.named_parameters()):
                assert float((s_card[n] - r).abs().max()) <= 1e-6 * max(1.0, float(r.abs().max())), n
            elif n == "queue_ptr":
                assert int(s_card[n]) == int(r)
            elif r.is_floating_point() and (n == "queue" or "running" in n):
                assert float((s_card[n] - r).abs().max()) <= 1e-3 * max(1.0, float(r.abs().max())), n
    assert passing >= 6, f"{passing} of 12 batches pass every gradient bound: {errors}"


@pytest.mark.parametrize("name", sorted(OBJECTIVE_LAUNCHES))
def test_objective_bf16_step_launch_counts(cuda, name):
    """One bf16 training step (views from waves) launches the log-mel kernel
    once and block 1's kernels as chip_smoke.TRAIN_LAUNCHES says."""
    from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.ops import block1
    from audiossl_tpu_torch.train.optim import sgd_torch
    from audiossl_tpu_torch.train.step import TrainStep

    cfg = _objective_config(name, "bfloat16")
    pre = cfg["pretrain"]
    frontend = build_frontend(pre["input"])
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=10**6)
    obj = init_objective(name, cfg, seed=0, device=cuda).train()
    step = TrainStep(obj, pipeline, frontend, sgd_torch([p for p in obj.parameters() if p.requires_grad], 0.03),
                     torch.Generator(cuda).manual_seed(0))
    state = pipeline.init_state(frontend.n_mels, frontend.num_frames(15200), cuda)
    waves = torch.from_numpy((0.3 * np.random.default_rng(5).standard_normal((8, 15200))).astype(np.float32)).to(cuda)
    labels = torch.arange(8, device=cuda) % 7
    wrappers = (fused_stft.log_mel_fused, block1.block1_fwd, block1.block1_bwd_sums, block1.block1_bwd_weight)
    for fn in wrappers:
        fn.launches = 0
    _, loss = step(state, waves, labels)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert tuple(fn.launches for fn in wrappers) == OBJECTIVE_LAUNCHES[name]


# ---------------------------------------------------------------- the clustering family


def test_fused_block1_takes_a_strided_input(cuda):
    """A transposed view (a log-mel moved to the card as it lay on the CPU)
    gives the contiguous input's result: the wrapper copies it once."""
    from audiossl_tpu_torch.ops import block1

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((4, 1, 20, 16)).astype(np.float32)).to(cuda).transpose(2, 3)
    w = torch.from_numpy((0.3 * rng.standard_normal((64, 1, 3, 3))).astype(np.float32)).to(cuda)
    vecs = [torch.from_numpy((o + 0.1 * rng.standard_normal(64)).astype(np.float32)).to(cuda) for o in (0.0, 1.0, 0.0)]
    assert not x.is_contiguous()
    got = block1.fused_block1(x, w, *vecs)
    want = block1.fused_block1(x.contiguous(), w, *vecs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_clustering_on_the_card_matches_cpu(cuda):
    """k-means++ / Lloyd, the bank's spherical k-means, tensor PIC and
    Kmix's partner search give the CPU's indices on the card."""
    from audiossl_tpu_torch.data import augment
    from audiossl_tpu_torch.objectives import clustering, decar

    rng = np.random.default_rng(7)
    cents = 3.0 * rng.standard_normal((6, 16))
    x = (cents[rng.integers(0, 6, 300)] + 0.2 * rng.standard_normal((300, 16))).astype(np.float32)
    first, u = clustering.kmeans_draws(300, 6, np.random.default_rng(0))
    runs = [clustering.kmeans_l2(torch.from_numpy(x).to(dev), 6, first, u) for dev in (cuda, "cpu")]
    assert torch.equal(runs[0][0].cpu(), runs[1][0])
    bank = torch.nn.functional.normalize(torch.from_numpy(x), dim=1)
    pick = torch.from_numpy(np.random.default_rng(1).permutation(300)[:6])
    got = [decar.kmeans_on_mesh(bank.to(dev), torch.arange(300, device=dev), 320, 6, pick)[1].cpu() for dev in (cuda, "cpu")]
    assert torch.equal(*got) and int((got[0] == -100).sum()) == 20
    i, d = clustering.knn_graph(torch.from_numpy(x), 5)
    assert np.array_equal(clustering.run_pic_device(i, d, device=cuda), clustering.run_pic(i, d))
    spec = torch.from_numpy(rng.standard_normal((40, 16, 12)).astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((5, 1, 16, 12)).astype(np.float32))
    g = torch.from_numpy(rng.gumbel(size=(5, 40)).astype(np.float32))
    c = torch.from_numpy(cents.astype(np.float32))
    idx = [augment.kmix_partner_index(augment.MixupBankState(spec.to(dev), 32, 32), q.to(dev), c.to(dev), g.to(dev), 8)
           for dev in (cuda, "cpu")]
    assert torch.equal(idx[0].cpu(), idx[1])


@pytest.mark.parametrize("name", ["decar_v2", "decar_v1"])
def test_clustering_bf16_step_launch_counts(cuda, name):
    """One bf16 step of DECAR-v2 (DecarStep: 1 / 2 / 1 / 1) and of
    DeepCluster-v1 (TrainStep on the un-augmented view: 1 / 1 / 1 / 1)."""
    import os

    import yaml

    from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.ops import block1
    from audiossl_tpu_torch.train.decar_loop import DecarStep
    from audiossl_tpu_torch.train.deepcluster_loop import build_net
    from audiossl_tpu_torch.train.optim import build_optimizer, sgd_torch
    from audiossl_tpu_torch.train.step import TrainStep

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    pre = cfg["pretrain"]
    pre["base_encoder"]["output_dim"] = 64
    pre.update(nmb_prototypes=[16], num_clusters=16)
    frontend = build_frontend(pre["input"])
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=10**6)
    gen = torch.Generator(cuda).manual_seed(0)
    if name == "decar_v2":
        obj = init_objective(name, cfg, seed=0, device=cuda).train()
        opt, _ = build_optimizer("larc", list(obj.parameters()), 0.5, clip=False)
        step = DecarStep(obj, pipeline, frontend, opt, gen, None, "mean_var", torch.zeros((32, 128), device=cuda),
                         torch.full((32,), -1, device=cuda), torch.randint(0, 16, (1, 32), device=cuda))
        want = (1, 2, 1, 1)
    else:
        obj = build_net(pre, 0, cuda).train()
        step = TrainStep(obj, pipeline, frontend, sgd_torch(list(obj.parameters()), 0.05, 0.9, 1e-5), gen, None, "none")
        want = (1, 1, 1, 1)
    state = pipeline.init_state(frontend.n_mels, frontend.num_frames(15200), cuda)
    waves = torch.from_numpy((0.3 * np.random.default_rng(5).standard_normal((8, 15200))).astype(np.float32)).to(cuda)
    wrappers = (fused_stft.log_mel_fused, block1.block1_fwd, block1.block1_bwd_sums, block1.block1_bwd_weight)
    for fn in wrappers:
        fn.launches = 0
    _, loss = step(state, waves, torch.arange(8, device=cuda) % 16)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert tuple(fn.launches for fn in wrappers) == want


# ---------------------------------------------------------------- the supervised MAST fine-tune


def _finetune_config(**ft):
    """configs/mast_ft.yaml at MAST tiny, 64 mels x 96 frames (1 s clips),
    its SpecMask scaled to the grid."""
    import os

    import yaml

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "mast_ft.yaml")) as f:
        cfg = yaml.safe_load(f)["finetune"]
    cfg.update(model_size="tiny", freqm=12, timem=18, **ft)
    cfg["input"].update(n_mels=64, target_length=96, length_wave=1.0)
    return cfg


@pytest.mark.parametrize("accum", [1, 2])
def test_finetune_bf16_step_launch_counts(cuda, accum):
    """One bf16 fine-tune step of MAST tiny (every augmentation on) at B=4
    launches, per microbatch, the Kaldi rows kernel once and each attention
    kernel once a block; an eval batch the rows kernel and the forward."""
    from audiossl_tpu_torch.ops import attention as A
    from audiossl_tpu_torch.train import finetune_mast as ftm
    from audiossl_tpu_torch.train.layer_decay import adamw_layer_decay

    ft = _finetune_config()
    model = ftm.init_classifier(ft, 10, seed=0, device=cuda).train()
    opt = adamw_layer_decay(model.named_parameters(), 5e-4, ftm.MVIT_DEPTH["tiny"], 0.75, 0.05, clip_grad_norm=1.0)
    step = ftm.FinetuneStep(model, opt, ft, torch.Generator(cuda).manual_seed(0), accum)
    waves = torch.from_numpy((0.3 * np.random.default_rng(6).standard_normal((4, 16000))).astype(np.float32)).to(cuda)
    targets = (torch.rand((4, 10), generator=torch.Generator().manual_seed(1)) < 0.3).float().to(cuda)
    wrappers = (A.rel_attention_fwd, A.rel_attention_bwd_dq, A.rel_attention_bwd_dkv)
    depth = len(model.mast.blocks)

    def counts():
        return (fused_stft.fused_rows.launches["kaldi"], *(fn.launches for fn in wrappers))

    before = counts()
    loss = step(waves, targets)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert tuple(a - b for a, b in zip(counts(), before)) == (accum, accum * depth, accum * depth, accum * depth)
    before = counts()
    scores = step.scores(waves)
    torch.cuda.synchronize()
    assert scores.shape == (4, 10) and bool(((scores >= 0) & (scores <= 1)).all())
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, depth, 0, 0)


@pytest.mark.parametrize("batched", [True, False])
def test_ssmast_accumulation_on_the_card_matches_one_pass(cuda, batched):
    """SS-MAST (MAST tiny, f32, drop path 0, B=4, a 64-key queue) at
    grad_accum_steps 2 against 1 on the card, from the same state: the
    loss within 1e-5 (relative), each gradient tensor within 1e-5 of its
    max|ref| + 1e-2 of the largest, the queue within 1e-6, the pointer equal."""
    import copy
    import os

    import yaml

    from audiossl_tpu_torch.objectives import init_objective

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "ssmast.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"].update(model_size="tiny", num_negatives=64, contrastive_dim=16, droppath_rate=0.0,
                           compute_dtype="f32", batched_views=batched)
    cfg["pretrain"]["input"].update(n_mels=64, target_length=96)
    init = init_objective("ssmast", cfg, seed=0, device=cuda).train()
    r = np.random.default_rng(8)
    v1, v2 = (torch.from_numpy(r.standard_normal((4, 1, 64, 96)).astype(np.float32)).to(cuda) for _ in range(2))
    out = []
    for accum in (1, 2):
        obj = copy.deepcopy(init)
        obj.grad_accum = accum
        loss = obj.loss_and_backward(v1, v2)
        out.append((float(loss), {n: p.grad for n, p in obj.encoder.named_parameters()}, obj.queue, int(obj.queue_ptr)))
    (l1, g1, q1, p1), (l2, g2, q2, p2) = out
    largest = max(float(g.abs().max()) for g in g1.values())
    assert abs(l2 - l1) <= 1e-5 * abs(l1)
    for n, g in g1.items():
        assert float((g2[n] - g).abs().max()) <= 1e-5 * (float(g.abs().max()) + 1e-2 * largest), n
    assert float((q2 - q1).abs().max()) <= 1e-6 and p1 == p2 == 8


# ---------------------------------------------------------------- rel-pos attention


def _attn_inputs(bh, lq, grid, d, dtype, device, seed=0, lk=77):
    r = np.random.default_rng(seed)
    lk = grid[0] * grid[1] if grid else lk
    t = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(device, dtype)
    q, k, v, do = t(bh, lq, d), t(bh, lk, d), t(bh, lk, d), t(bh, lq, d)
    bias = (0.5 * t(bh, lq, grid[0] + grid[1])).contiguous() if grid else None
    return q, k, v, bias, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,lq,grid,d", [(3, 72, (5, 8), 24), (2, 1100, (13, 10), 96), (4, 37, (3, 11), 96),
                                          (2, 301, (51, 6), 96), (3, 45, None, 64),
                                          # MAST-B's shapes on the probe's 9 x 5 token grid, at B = 2
                                          (2, 45, (3, 2), 96), (4, 15, (5, 3), 96), (8, 6, (5, 3), 96),
                                          (16, 2, (3, 2), 96), (16, 2, (2, 1), 96)])
def test_attention_kernels_match_plain(cuda, dtype, bh, lq, grid, d):
    from audiossl_tpu_torch.ops import attention as A

    q, k, v, bias, do = _attn_inputs(bh, lq, grid, d, dtype, cuda)
    qs = A.scale_q(q, d**-0.5)
    runs = []
    for _ in range(2):
        out = A.rel_attention_fwd(qs, k, v, bias, grid)
        dq, dbias, stats = A.rel_attention_bwd_dq(qs, k, v, bias, grid, d**-0.5, do)
        dk, dv = A.rel_attention_bwd_dkv(qs, k, v, bias, grid, do, stats)
        torch.cuda.synchronize()
        runs.append([out, dq, dk, dv] + ([dbias] if grid else []))
    for a, b in zip(*runs):  # no atomics: two runs give the same bits
        assert torch.equal(a, b)
    want_out = A.attention_fwd_plain(qs, k, v, bias, grid)
    want_dq, want_db, want_st = A.attention_bwd_dq_plain(qs, k, v, bias, grid, d**-0.5, do)
    want_dk, want_dv = A.attention_bwd_dkv_plain(qs, k, v, bias, grid, do, want_st)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7  # relative to max(1, max|ref|); bf16: one ulp
    for name, got, want in zip(("out", "dq", "dk", "dv", "dbias"), runs[0],
                               [want_out, want_dq, want_dk, want_dv] + ([want_db] if grid else [])):
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = max(1.0, float(want.float().abs().max()))
        assert float((got.float() - want.float()).abs().max()) <= tol * scale * (1 if name == "out" else 4), name
    torch.testing.assert_close(stats, want_st, rtol=1e-5, atol=1e-5)


# MAST-B's attention shapes at B = 64, two views in one pass (chip_smoke.py's
# MAST_ATTN), then a ragged Lq, the 13 x 2 grid at a small batch and the no-bias mode
MAST_BWD_SHAPES = [(128, 1212, (26, 3)), (256, 306, (51, 6)), (256, 306, (26, 3)), (512, 78, (51, 6)),
                   (512, 78, (26, 3)), (1024, 26, (26, 3)), (1024, 26, (13, 2)),
                   (5, 1001, (26, 3)), (7, 93, (13, 2)), (6, 300, None)]


@pytest.mark.parametrize("bh,lq,grid", MAST_BWD_SHAPES)
def test_attention_backward_bf16_tensor_core_kernels(cuda, bh, lq, grid):
    """Both backward kernels in bf16 (the tensor-core design) against their
    plain versions within 4 bf16 ulps of max|ref|, the row statistics within
    1e-5, and two runs bit for bit."""
    from audiossl_tpu_torch.ops import attention as A

    d = 96
    q, k, v, bias, do = _attn_inputs(bh, lq, grid, d, torch.bfloat16, cuda, seed=lq)
    qs = A.scale_q(q, d**-0.5)
    runs = []
    for _ in range(2):
        dq, dbias, stats = A.rel_attention_bwd_dq(qs, k, v, bias, grid, d**-0.5, do)
        dk, dv = A.rel_attention_bwd_dkv(qs, k, v, bias, grid, do, stats)
        torch.cuda.synchronize()
        runs.append([dq, dk, dv, stats] + ([dbias] if grid else []))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    dq, dk, dv, stats = runs[0][:4]
    want_dq, want_db, want_st = A.attention_bwd_dq_plain(qs, k, v, bias, grid, d**-0.5, do)
    want_dk, want_dv = A.attention_bwd_dkv_plain(qs, k, v, bias, grid, do, stats)  # the kernel's own statistics
    torch.testing.assert_close(stats, want_st, rtol=1e-5, atol=1e-5)
    for name, got, want in zip(("dq", "dk", "dv", "dbias"), runs[0][:3] + runs[0][4:], [want_dq, want_dk, want_dv, want_db]):
        assert got.dtype == want.dtype and got.shape == want.shape and torch.isfinite(got.float()).all(), name
        ref = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= 4 * _bf16_ulp(ref), name


@pytest.mark.parametrize("bh,lq,grid", MAST_BWD_SHAPES)
def test_attention_forward_bf16_tensor_core_kernel(cuda, bh, lq, grid):
    """The bf16 forward (the tensor-core designs: resident with a bias, 64
    or 128 query rows a block; streamed over keys without, 128) at every
    MAST-B shape, a ragged Lq and the no-bias mode against its plain version
    within 2 bf16 ulps of max|ref|; one launch a call, and two runs bit for
    bit."""
    from audiossl_tpu_torch.ops import attention as A

    d = 96
    q, k, v, bias, _ = _attn_inputs(bh, lq, grid, d, torch.bfloat16, cuda, seed=lq + 1)
    qs = A.scale_q(q, d**-0.5)
    assert A._lib().audiossl_attn_tile(0, k.shape[1], d, sum(grid) if grid else 0, 1) in (64, 128)
    before = A.rel_attention_fwd.launches
    runs = [A.rel_attention_fwd(qs, k, v, bias, grid) for _ in range(2)]
    torch.cuda.synchronize()
    assert A.rel_attention_fwd.launches == before + 2
    assert torch.equal(runs[0], runs[1])
    want = A.attention_fwd_plain(qs, k, v, bias, grid)
    got = runs[0]
    assert got.dtype == want.dtype and got.shape == want.shape and torch.isfinite(got.float()).all()
    ref = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2 * _bf16_ulp(ref)


# AST's no-bias attention at key lengths whose k and v would not fit in
# shared memory (the streamed kernels): AST-base's 1214 tokens at a small batch, a ragged 1500,
# keys one past a multiple of the 64-key chunk (a last chunk of one key), and
# fewer queries than keys
AST_SHAPES = [(24, 1214, 1214), (4, 1500, 1500), (6, 1217, 1217), (5, 300, 1217),
              (192, 1214, 1214)]  # the last: each rank's AST-base attention under downstream.tp 2 (B=32, 6 of 12 heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,lq,lk", AST_SHAPES)
def test_attention_streamed_kernels_match_plain(cuda, dtype, bh, lq, lk):
    """The forward, dq and dk/dv with no bias at key lengths whose k and v
    would not fit in shared memory, against their plain versions: f32 out within 1e-5
    and gradients within 1e-4 of max(1, max|ref|); bf16 out within 2 and
    gradients within 4 bf16 ulps of max|ref|; one launch each a call, and two
    runs bit for bit."""
    from audiossl_tpu_torch.ops import attention as A

    d = 64
    bf16 = int(dtype == torch.bfloat16)
    assert all(A._lib().audiossl_attn_tile(which, lk, d, 0, bf16) for which in range(3))
    q, k, v, _, do = _attn_inputs(bh, lq, None, d, dtype, cuda, seed=lk, lk=lk)
    qs = A.scale_q(q, d**-0.5)
    before = A.rel_attention_fwd.launches, A.rel_attention_bwd_dq.launches, A.rel_attention_bwd_dkv.launches
    runs = []
    for _ in range(2):
        out = A.rel_attention_fwd(qs, k, v, None, None)
        dq, _, stats = A.rel_attention_bwd_dq(qs, k, v, None, None, d**-0.5, do)
        dk, dv = A.rel_attention_bwd_dkv(qs, k, v, None, None, do, stats)
        torch.cuda.synchronize()
        runs.append([out, dq, dk, dv, stats])
    after = A.rel_attention_fwd.launches, A.rel_attention_bwd_dq.launches, A.rel_attention_bwd_dkv.launches
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, dq, dk, dv, stats = runs[0]
    want_dq, _, want_st = A.attention_bwd_dq_plain(qs, k, v, None, None, d**-0.5, do)
    want_dk, want_dv = A.attention_bwd_dkv_plain(qs, k, v, None, None, do, stats)
    torch.testing.assert_close(stats, want_st, rtol=1e-5, atol=1e-5)
    for name, got, want in (("out", out, A.attention_fwd_plain(qs, k, v, None, None)), ("dq", dq, want_dq),
                            ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert got.dtype == want.dtype and got.shape == want.shape and torch.isfinite(got.float()).all(), name
        ref = float(want.float().abs().max())
        if dtype == torch.float32:
            tol = (1e-5 if name == "out" else 1e-4) * max(1.0, ref)
        else:
            tol = (2 if name == "out" else 4) * _bf16_ulp(ref)
        assert float((got.float() - want.float()).abs().max()) <= tol, name


def test_attention_function_on_the_card_matches_cpu(cuda):
    from audiossl_tpu_torch.ops import attention as A

    q, k, v, bias, do = _attn_inputs(2, 130, (4, 6), 32, torch.float32, "cpu", seed=3)
    grads = []
    for dev in (cuda, "cpu"):
        ts = [t.to(dev).requires_grad_() for t in (q, k, v, bias)]
        before = A.rel_attention_fwd.launches, A.rel_attention_bwd_dq.launches, A.rel_attention_bwd_dkv.launches
        A.fused_rel_attention(*ts, (4, 6), 32**-0.5).backward(do.to(dev))
        after = A.rel_attention_fwd.launches, A.rel_attention_bwd_dq.launches, A.rel_attention_bwd_dkv.launches
        assert [a - b for a, b in zip(after, before)] == ([1, 1, 1] if dev == cuda else [0, 0, 0])
        grads.append([t.grad.cpu() for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("encoder", ["MAST", "AST"])
def test_fbank_serving_on_the_card_matches_cpu(cuda, encoder):
    """A tiny encoder behind the Kaldi fbank (64 bins x 96 frames), served in
    f32 on the card: one rows launch and one attention forward a block per
    batch, the CPU path's embeddings within 1e-3 of max(1, max|ref|)."""
    from audiossl_tpu_torch.frontend import FrontendSpec
    from audiossl_tpu_torch.ops import attention as A
    from audiossl_tpu_torch.serve.export import ServingEncoder, build_embedder, seeded_state_dict

    spec = FrontendSpec("fbank", 64, 16000, target_length=96)
    sd = seeded_state_dict(encoder, "tiny", 64, 96, 0, seed=1)
    artifact = build_embedder(sd, spec, 16000, torch.float32, "cpu", encoder, "tiny").artifact()
    waves = (0.3 * np.random.default_rng(5).standard_normal((3, 16000))).astype(np.float32)
    want = ServingEncoder(artifact, device="cpu")(waves)
    enc = ServingEncoder(artifact, device=cuda)
    rows, fwd = fused_stft.fused_rows.launches["kaldi"], A.rel_attention_fwd.launches
    got = enc(waves)
    depth = len(enc.embedder.model.encoder.blocks)
    assert (fused_stft.fused_rows.launches["kaldi"] - rows, A.rel_attention_fwd.launches - fwd) == (1, depth)
    assert float(np.abs(got - want).max()) <= 1e-3 * max(1.0, float(np.abs(want).max()))


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from audiossl_tpu_torch.ops import attention as A

    q, k, v, bias, do = _attn_inputs(2, 40, (3, 4), 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        A.rel_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, bias, (3, 4))
    with pytest.raises(ValueError, match="f32 or bf16"):
        A.rel_attention_fwd(q.half(), k.half(), v.half(), bias.half(), (3, 4))
    with pytest.raises(ValueError, match="rel_expand_matrix"):
        A.rel_attention_fwd(q, k, v, bias, (torch.rand(7, 12) < 0.3).float())
    with pytest.raises(ValueError, match="one dtype"):
        A.rel_attention_bwd_dq(q, k, v, bias, (3, 4), 0.1, do.bfloat16())
    # the f32 forward streams the keys but keeps whole score rows: beyond ~6,000 keys they do not fit
    short, long = torch.zeros((8, 8, 96), device=cuda), torch.zeros((8, 16000, 96), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        A.rel_attention_fwd(short, long, long, None, None)
    odd = torch.zeros((2, 16, 20), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        A.rel_attention_bwd_dq(odd, odd, odd, None, None, 0.1, odd)
    assert A.rel_attention_fwd(q, k, v, bias, A.rel_expand_matrix(3, 4)).shape == q.shape  # the checked matrix


# ---------------------------------------------------------------- dense spectrogram rows


@pytest.mark.parametrize("n", [160000, 400, 12345, 555])  # 10 s; one frame; rows not a multiple of the tile
def test_fused_rows_kaldi_matches_plain(cuda, n):
    from audiossl_tpu_torch.frontend.fbank import kaldi_fbank

    w = torch.from_numpy((0.5 * np.random.default_rng(n).standard_normal((3, n))).astype(np.float32)).to(cuda)
    before = fused_stft.fused_rows.launches["kaldi"]
    got = fused_stft.kaldi_fbank_fused(w)
    want = kaldi_fbank(w)
    torch.cuda.synchronize()
    assert fused_stft.fused_rows.launches["kaldi"] == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-3
    assert torch.equal(got, fused_stft.kaldi_fbank_fused(w))


@pytest.mark.parametrize("n", [15200, 600, 12345])  # 600: 4 frames (reflect padding needs n > n_fft / 2)
def test_fused_rows_librosa_matches_plain(cuda, n):
    w = torch.from_numpy((0.5 * np.random.default_rng(n).standard_normal((2, n))).astype(np.float32)).to(cuda)
    before = fused_stft.fused_rows.launches["librosa"]
    got = fused_stft.log_mel_dense_fused(w)
    want = log_mel(w)
    torch.cuda.synchronize()
    assert fused_stft.fused_rows.launches["librosa"] == before + 1
    assert got.shape == want.shape and float((got - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("cfg,n", [(LogMelConfig(n_fft=400), 8000), (LogMelConfig(n_fft=600, hop=100, n_mels=40), 5000),
                                   (LogMelConfig(n_fft=512, hop=128, n_mels=40), 5000),
                                   (LogMelConfig(n_fft=2048, hop=512, n_mels=128), 20000)])
def test_fused_rows_other_widths_match_plain(cuda, cfg, n):
    """Widths that are not a power of two take the dense design, the others
    the FFT design (odd log2(N/2) at 512, a larger N at 2048)."""
    w = torch.from_numpy((0.5 * np.random.default_rng(n).standard_normal((2, n))).astype(np.float32)).to(cuda)
    before = fused_stft.fused_rows.launches["librosa"]
    got = fused_stft.log_mel_dense_fused(w, cfg)
    want = log_mel(w, cfg)
    torch.cuda.synchronize()
    assert fused_stft.fused_rows.launches["librosa"] == before + 1
    assert got.shape == want.shape and float((got - want).abs().max()) <= 1e-3


def test_logmel_features_sends_other_widths_to_the_rows_kernel(cuda):
    """A config that is not ct_eligible (n_fft = 400) runs the rows kernel in
    librosa mode on a CUDA tensor, never the plain version."""
    from audiossl_tpu_torch.frontend import logmel_features

    cfg = LogMelConfig(n_fft=400, hop=160)
    w = torch.from_numpy((0.5 * np.random.default_rng(3).standard_normal((4, 15200))).astype(np.float32)).to(cuda)
    before = dict(fused_stft.fused_rows.launches), fused_stft.log_mel_fused.launches
    got = logmel_features(w, cfg)
    torch.cuda.synchronize()
    assert fused_stft.fused_rows.launches == {**before[0], "librosa": before[0]["librosa"] + 1}
    assert fused_stft.log_mel_fused.launches == before[1]
    want = log_mel(w, cfg)
    assert got.shape == want.shape and float((got - want).abs().max()) <= 1e-3


def test_fused_rows_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    from audiossl_tpu_torch.frontend.fbank import FbankConfig

    w = torch.zeros((2, 16000), device=cuda)
    with pytest.raises(ValueError, match="contiguous f32"):
        fused_stft.kaldi_fbank_fused(w[:, ::2])
    with pytest.raises(ValueError, match="contiguous f32"):
        fused_stft.kaldi_fbank_fused(w.double())
    with pytest.raises(ValueError, match="contiguous f32"):
        fused_stft.log_mel_dense_fused(w.bfloat16())
    with pytest.raises(ValueError, match="do not fit the bank"):
        fused_stft.fused_rows(torch.zeros((4, 512), device=cuda), FbankConfig(), "kaldi")


# ---------------------------------------------------------------- data parallelism (slice 13)


def test_syncbn_block1_kernels_across_two_ranks_on_the_card(cuda, tmp_path):
    """Two gloo ranks share the card (NCCL refuses two ranks on one GPU),
    each with 2 of 4 clips: block 1's kernels with the group's statistics
    and summed backward terms give the one-process kernels' output on all 4
    clips (forward and statistics 1e-5 of max(1, max|ref|); the mean of the
    gradients 1e-4 of each tensor's max|ref| (TOL_B1_GRAD of chip_smoke.py)
    plus 1e-5 of the largest gradient, since the conv bias before a
    batch-statistics BN has an exactly zero gradient and only round-off is
    left there), each kernel launched once a rank, two SyncBN all-reduces a
    rank."""
    import socket

    from audiossl_tpu_torch.ops import block1
    from tests import torch_ddp_worker as worker

    rng = np.random.default_rng(0)
    c, f, t = 64, 16, 24
    d = {"x": rng.standard_normal((4, f, t)).astype(np.float32),
         "w": (0.3 * rng.standard_normal((c, 1, 3, 3))).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
         "gamma": (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
         "beta": (0.1 * rng.standard_normal(c)).astype(np.float32),
         "cot": rng.standard_normal((4, c, f // 2, t // 2)).astype(np.float32)}
    torch.save(d, str(tmp_path / "in.pt"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(worker.run_on_card, args=(2, port, str(tmp_path / "in.pt"), str(tmp_path)), nprocs=2,
                                join=True)
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(2)]
    want = worker.block1_check({**d, "device": "cuda"})
    assert want["launches"] == [1, 1, 1]
    pooled = np.concatenate([r["pooled"] for r in ranks])
    assert np.abs(pooled - want["pooled"]).max() <= 1e-5 * max(1.0, np.abs(want["pooled"]).max())
    largest = max(float(np.abs(want[k]).max()) for k in ("dw", "dbias", "dgamma", "dbeta"))
    for r in ranks:
        assert r["launches"] == [1, 1, 1] and r["calls"] == {"syncbn": 2, "all_reduce_grads": 1}
        for k in ("mean", "var"):
            assert np.abs(r[k] - want[k]).max() <= 1e-5 * max(1.0, np.abs(want[k]).max()), k
        for k in ("dw", "dbias", "dgamma", "dbeta"):
            assert np.abs(r[k] - want[k]).max() <= 1e-4 * np.abs(want[k]).max() + 1e-5 * largest, k
    assert block1.block1_fwd.launches >= 1


# ---------------------------------------------------------------- tensor parallelism (slice 14)


def test_tensor_parallel_f32_gate_on_the_card(cuda, tmp_path):
    """Two gloo ranks share the card at tp 2, f32: MAST-tiny (4 blocks,
    64 x 96) and AST (tiny's width with 4 heads, depth 2,
    at 1214 tokens: the streamed f32 attention), sharded over the model
    axis, against one process on the card on the same weights and inputs:
    the forward within 1e-5 of max(1, max|ref|), each gradient within 1e-3
    of its own max|ref| + 1e-5 of the largest (the CPU tp test's bounds);
    per rank the attention kernels launched once a block each way (MAST:
    on all heads, as JAX's partitioner leaves its attention replicated;
    AST: on 2 of the 4 heads)."""
    import socket

    from audiossl_tpu_torch.models import ast as past
    from audiossl_tpu_torch.models import mast as pmast
    from tests import torch_tp_worker as worker

    saved = dict(pmast.VARIANTS), dict(past.VARIANTS)
    worker.cut_tiny()
    try:
        rng = np.random.default_rng(0)
        inputs = {}
        for kind, f, t, width in (("mast", 64, 96, 768), ("ast", 128, 1025, 192)):
            torch.manual_seed(1)
            model = (pmast.MASTEncoder(f, t, "tiny", compute_dtype=None) if kind == "mast" else
                     past.ASTEncoder(f, t, "tiny"))
            inputs[kind] = {"kind": kind, "f": f, "t": t, "state": {k: v.numpy() for k, v in model.state_dict().items()},
                            "x": rng.standard_normal((2, 1, f, t)).astype(np.float32),
                            "cot": rng.standard_normal((2, width)).astype(np.float32)}
        torch.save(inputs, str(tmp_path / "in.pt"))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        torch.multiprocessing.spawn(worker.run_on_card, args=(2, port, str(tmp_path / "in.pt"), str(tmp_path)),
                                    nprocs=2, join=True)
        ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(2)]
        for kind, blocks in (("mast", 4), ("ast", 2)):
            want = worker.encoder_check({**inputs[kind], "device": "cuda"})
            largest = max(float(np.abs(g).max()) for g in want["grads"].values())
            for r in ranks:
                got = r[kind]
                assert got["launches"] == [blocks] * 3, kind
                assert np.abs(got["y"] - want["y"]).max() <= 1e-5 * max(1.0, np.abs(want["y"]).max()), kind
                for n, g in want["grads"].items():
                    assert np.abs(got["grads"][n] - g).max() <= 1e-3 * np.abs(g).max() + 1e-5 * largest, (kind, n)
    finally:
        pmast.VARIANTS.update(saved[0])
        past.VARIANTS.update(saved[1])



# ---------------------------------------------------------------- sharded training state (slice 15)


def test_sharded_state_f32_gates_on_the_card(cuda, tmp_path):
    """Two gloo ranks share the card, f32, MAST tiny cut to 2 blocks at 64 x
    96: one SS-MAST step under run.fsdp, one under run.zero_optimizer (AdamW
    at eps 1e-4), one fine-tune step under fsdp with the clip engaged (1e-2),
    each against one process on the card on the same 4 clips: the loss and
    the clip's norm 1e-5 relative; each gradient within 1e-3 of its own
    max|ref| + 1e-5 of the largest (the CPU test's bounds); ZeRO's state
    after the step 1e-5 of max(1, max|ref|); per rank the attention kernels
    once a block and pass (SS-MAST's query and key passes forward, the
    query's backward) and the fine-tune's one Kaldi rows launch."""
    import os
    import socket

    import yaml

    from audiossl_tpu_torch.models import mast as pmast
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.train import finetune_mast as ft
    from tests import torch_fsdp_zero_worker as worker

    saved = dict(pmast.VARIANTS)
    worker.cut_tiny()
    try:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(root, "configs", "ssmast.yaml")) as f:
            cfg = yaml.safe_load(f)
        cfg["pretrain"].update(model_size="tiny", num_negatives=256, contrastive_dim=16, droppath_rate=0.0,
                               compute_dtype="f32", steps_per_epoch=2)
        cfg["pretrain"]["input"].update(n_mels=64, target_length=96)
        rng = np.random.default_rng(0)
        ss = {"config": cfg, "state": {k: v.numpy() for k, v in init_objective("ssmast", cfg, seed=0).state_dict().items()},
              "v1": rng.standard_normal((4, 1, 64, 96)).astype(np.float32),
              "v2": rng.standard_normal((4, 1, 64, 96)).astype(np.float32)}
        ft_cfg = {"model_size": "tiny", "freqm": 0, "timem": 0, "compute_dtype": "f32", "droppath_rate": 0.0,
                  "norm_stats": {"mean": -13.9, "std": 5.3},
                  "input": {"type": "fbank", "sampling_rate": 16000, "length_wave": 0.5, "n_mels": 64,
                            "target_length": 96, "mixup": 0.0, "noise": False}}
        fd = {"ft": ft_cfg, "n_classes": 4, "clip": 1e-2,
              "state": {k: v.numpy() for k, v in ft.init_classifier(ft_cfg, 4, 0, "cpu").state_dict().items()},
              "waves": (0.3 * rng.standard_normal((4, 8000))).astype(np.float32),
              "targets": (rng.random((4, 4)) < 0.4).astype(np.float32)}
        inputs = {"ssmast_fsdp": ss, "zero_ssmast": {**ss, "name": "ssmast"}, "finetune_fsdp": fd}
        torch.save(inputs, str(tmp_path / "in.pt"))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        torch.multiprocessing.spawn(worker.run_on_card, args=(2, port, str(tmp_path / "in.pt"), str(tmp_path)),
                                    nprocs=2, join=True)
        ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(2)]
        want = {name: worker.CHECKS[name]({**d, "device": "cuda"}) for name, d in inputs.items()}

        def grads_close(got, ref):
            largest = max(float(np.abs(g).max()) for g in ref.values())
            return [n for n, g in ref.items() if not np.abs(got[n] - g).max() <= 1e-3 * np.abs(g).max() + 1e-5 * largest]

        for r in ranks:
            for name, w in want.items():
                assert abs(float(r[name]["loss"]) - float(w["loss"])) <= 1e-5 * abs(float(w["loss"])), name
            assert not grads_close(r["ssmast_fsdp"]["grads"], want["ssmast_fsdp"]["grads"])
            assert not grads_close(r["finetune_fsdp"]["grads"], want["finetune_fsdp"]["grads"])
            assert abs(r["finetune_fsdp"]["norm"] - want["finetune_fsdp"]["norm"]) <= 1e-5 * want["finetune_fsdp"]["norm"]
            assert want["finetune_fsdp"]["norm"] > 1e-2
            for k, v in want["zero_ssmast"]["after"].items():
                assert np.abs(r["zero_ssmast"]["after"][k] - v).max() <= 1e-5 * max(1.0, np.abs(v).max()), k
            assert r["ssmast_fsdp"]["launches"] == r["zero_ssmast"]["launches"] == [4, 2, 2, 0]
            assert r["finetune_fsdp"]["launches"] == [2, 2, 2, 1]
    finally:
        pmast.VARIANTS.clear()
        pmast.VARIANTS.update(saved)


# ---------------------------------------------------------------- pipeline and sequence parallelism


@pytest.fixture(scope="module")
def parallel_lib_ranks(tmp_path_factory):
    """One spawn of two gloo ranks sharing the card (gloo refuses CUDA
    tensors for send / recv, so the pipeline's and the halo's exchanges are
    staged through the host): the pipeline at 2 stages, correct and with
    the planted summed output backward, and the sp log-mel of 10 s clips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tests import torch_parallel_lib_worker as worker

    rng = np.random.default_rng(0)
    pp = {"stages": 2, "heads": 3, "blocks": worker.jax_vit_blocks(4, 192, rng), "attention_f32": True,
          "x": (0.5 * rng.standard_normal((4, 1, 1214, 192))).astype(np.float32),
          "tgt": rng.standard_normal((4, 1, 1214, 192)).astype(np.float32)}
    inputs = {"pp": pp, "pp fault": {**pp, "fault": "summed_output_backward"},
              "sp": {"wave": (0.3 * rng.standard_normal((2, 160000))).astype(np.float32)}}
    tmp = tmp_path_factory.mktemp("parallel_lib")
    torch.save(inputs, str(tmp / "in.pt"))
    torch.multiprocessing.spawn(worker.run_on_card, args=(2, f"file://{tmp / 'rendezvous'}", str(tmp / "in.pt"), str(tmp)),
                                nprocs=2, join=True)
    return inputs, [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False) for r in range(2)]


def test_pipeline_f32_gate_on_the_card(cuda, parallel_lib_ranks):
    """A 4-block vit_block stack at AST-tiny's width (192, 3 heads) over
    1214 tokens (the streamed f32 attention kernels) in 2 stages, M = 4
    microbatches of 1, against the sequential stack in one process on the
    card: the loss 1e-5 relative, each gradient within 1e-3 of its own
    max|ref| + 1e-5 of the largest, the input's gradient 1e-3 of its max;
    each rank launches each attention kernel 2 blocks x 4 microbatches = 8
    times and exchanges at 4 ticks each way, each staged through the host
    (one copy a tick: down where it sends, up where it receives); the
    planted summed output backward (twice each gradient) fails the bound."""
    from tests import torch_parallel_lib_worker as worker

    inputs, ranks = parallel_lib_ranks
    pp = inputs["pp"]
    blocks = worker.vit_blocks(pp, range(4), cuda)
    x = torch.from_numpy(pp["x"]).to(cuda).requires_grad_()
    y = x.reshape(-1, *x.shape[2:])
    for blk in blocks:
        y = blk(y)
    loss = ((y.reshape(x.shape) - torch.from_numpy(pp["tgt"]).to(cuda)) ** 2).mean()
    loss.backward()
    loss = loss.item()
    want = {f"{i}.{n}": p.grad.cpu().numpy() for i, blk in enumerate(blocks) for n, p in blk.named_parameters()}
    largest = max(float(np.abs(g).max()) for g in want.values())

    def far(got, r):
        return [n for n, g in got.items()
                if not np.abs(g - want[f"{2 * r + int(n.split('.')[0])}.{n.split('.', 1)[1]}"]).max()
                <= 1e-3 * np.abs(want[f"{2 * r + int(n.split('.')[0])}.{n.split('.', 1)[1]}"]).max() + 1e-5 * largest]

    for r, res in enumerate(ranks):
        out = res["pp"]
        assert abs(out["loss"] - loss) <= 1e-5 * abs(loss)
        assert not far(out["grads"], r), r
        dx = x.grad.cpu().numpy()
        assert np.abs(out["dx"] - dx).max() <= 1e-3 * np.abs(dx).max()
        assert out["launches"] == [8, 8, 8, 0]
        assert out["calls"]["pp_permute"] == 8 and out["calls"]["host_staging_copy"] == 8
        assert len(far(res["pp fault"]["grads"], r)) == len(out["grads"]), r


def test_sp_log_mel_frames_on_the_card(cuda, parallel_lib_ranks):
    """10 s clips (the default config) padded by pad_for_sp and split over
    the two ranks: each rank's block from one log-mel launch on its slice
    and the halo; joined and cut to sp_num_frames, within the kernel's 1e-3
    of the one-process kernel on the whole clips (each frame reads the same
    samples, so the bits are expected equal)."""
    from audiossl_tpu_torch.frontend.sp import sp_num_frames

    inputs, ranks = parallel_lib_ranks
    wave = torch.from_numpy(inputs["sp"]["wave"]).to(cuda)
    want = fused_stft.log_mel_fused(wave, LogMelConfig()).cpu().numpy()
    got = np.concatenate([r["sp"]["out"] for r in ranks], axis=2)[..., :sp_num_frames(LogMelConfig(), 160000)]
    assert got.shape == want.shape == (2, 64, 1001)
    assert np.abs(got - want).max() <= 1e-3
    for r in ranks:
        assert r["sp"]["launches"] == [0, 0, 0, 1] and r["sp"]["calls"]["sp_halo"] == 1
