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
    "shape,ties", [((3, 16, 20), False), ((2, 8, 12), True), ((4, 64, 96), False), ((2, 64, 96), True), ((2, 8, 2000), False)]
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
    assert torch.equal(block1.block1_bwd_weight(x, dp, params), got[2])


def test_block1_wrappers_reject_bad_inputs(cuda):
    from audiossl_tpu_torch.ops import block1

    x, params, dp = _block1_inputs((2, 8, 12), torch.float32, cuda)
    with pytest.raises(ValueError, match="F and T even"):
        block1.block1_fwd(x[..., :11].contiguous(), params)
    with pytest.raises(ValueError, match="contiguous"):
        block1.block1_fwd(x.transpose(2, 3), params)
    with pytest.raises(ValueError, match="dp must be"):
        block1.block1_bwd_sums(x, dp.to(torch.bfloat16), params)


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
