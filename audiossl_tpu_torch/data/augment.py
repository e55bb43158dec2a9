"""Spectrogram augmentations with carried state (port of ``audiossl_tpu.data.augment``).

Two independently augmented views per step from the reference's
AugmentationModule (src/augmentations/__init__.py:5-35): RunningNorm
pre-normalization, then per view MixupBYOLA against a ring-buffer memory bank
and RandomResizeCrop. As on the JAX side, the bank is global per step and
takes the whole (pre-mix) batch once per view, so view 2 can draw view 1's
push.

Every stochastic op takes its draws as tensors (mixup weight and partner per
clip, Kmix's weight, uniform partner and Gumbel noise, the Gaussian noise's
weight and draws, crop box per clip); ``AugmentPipeline.sample_draws`` makes
them from an explicit ``torch.Generator``, and tests hand the JAX cores the
same draws. The bank is updated in place (its ring slots are overwritten)
to keep one copy of it on the device.

Ported: the delores_s configuration (RunningNorm or l2 / none, MixupBYOLA,
RandomResizeCrop), the delores_s_kmix one (Kmix against centroids of
time-averaged log-mel, augmentations.py:119-189), MixGaussianNoise, the
ssmast one (SpecMask, then the ``precomputed`` norm; the waveform mixup runs
before the frontend, in train/step.py) and MAST noise (``input.noise``),
applied last. A view is Mixup -> Kmix -> noise -> crop -> SpecMask -> norm ->
MAST noise, the JAX package's order.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, NamedTuple

import numpy as np
import torch

from audiossl_tpu_torch import no_tf32
from audiossl_tpu_torch.frontend.fbank import WaveMixDraws, sample_wave_mixup
from audiossl_tpu_torch.ops.masking import MaskDraws, sample_mask_draws, spec_mask
from audiossl_tpu_torch.ops.resize import random_resize_crop, sample_crop_boxes
from audiossl_tpu_torch.ops.stats import RunningNormState, precomputed_norm, running_norm_apply, running_norm_init

log = logging.getLogger("audiossl_tpu_torch.data")

EPS32 = 1.1920929e-7


def log_mixup_exp(xa: torch.Tensor, xb: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """alpha * exp(xa) + (1 - alpha) * exp(xb), back in the log domain."""
    return torch.log(alpha * torch.exp(xa) + (1.0 - alpha) * torch.exp(xb) + EPS32)


@dataclasses.dataclass
class MixupBankState:
    bank: torch.Tensor  # [N, F, T] bf16, stored spectrograms (channel squeezed)
    fill: int  # valid slots
    ptr: int  # next write position (ring)


def mixup_bank_init(n_memory: int, n_mels: int, n_frames: int, device: str | torch.device = "cpu") -> MixupBankState:
    return MixupBankState(torch.zeros((n_memory, n_mels, n_frames), dtype=torch.bfloat16, device=device), 0, 0)


def mixup_bank_push(state: MixupBankState, x: torch.Tensor) -> MixupBankState:
    """Write batch ``x [B, C, F, T]`` into the ring (in place) and advance it."""
    b, n = x.shape[0], state.bank.shape[0]
    idx = (state.ptr + torch.arange(b, device=x.device)) % n
    state.bank[idx] = x[:, 0].to(torch.bfloat16)
    return MixupBankState(state.bank, min(state.fill + b, n), (state.ptr + b) % n)


def mixup_byola(
    state: MixupBankState, x: torch.Tensor, alpha: torch.Tensor, index: torch.Tensor, log_domain: bool = True
) -> torch.Tensor:
    """Mix clip i of ``x [B, C, F, T]`` with bank entry ``index[i]`` at weight
    ``alpha[i]`` (= ratio * U(0, 1)): MixupBYOLA.forward
    (augmentations.py:97-111), the identity while the bank is empty."""
    if state.fill == 0:
        return x
    z = state.bank[index].to(x.dtype)[:, None]
    a = alpha.view(-1, 1, 1, 1)
    return log_mixup_exp(x, z, 1.0 - a) if log_domain else a * z + (1.0 - a) * x


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances [n, m], f32 with TF32 off."""
    with no_tf32():
        return (a * a).sum(-1, keepdim=True) - 2.0 * a @ b.T + (b * b).sum(-1)[None, :]


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def kmix_partner_index(state: MixupBankState, x: torch.Tensor, centroids: torch.Tensor, gumbel: torch.Tensor,
                       top_k: int = 128) -> torch.Tensor:
    """Kmix's partner in the bank for each clip of ``x [B, C, F, T]`` ->
    [B] bank indices, all clips at once. Kmix.get_index
    (augmentations.py:140-162): centroids and bank items are time-averaged
    to [n_mels] and L2-normalized (the query is *not* normalized, as in the
    reference); each bank item goes to its nearest centroid; the centroids
    are ranked by *descending* distance from the query's (torch.topk
    largest-first); the eligible items are those of the first rank that
    holds any, the first ``top_k`` of them in bank order, and the partner is
    the eligible item of largest ``gumbel [B, N]`` noise (a uniform draw)."""
    n, k = state.bank.shape[0], centroids.shape[0]
    c = _unit_rows(centroids.float())
    m = _unit_rows(state.bank.float().mean(dim=-1))  # [N, F]
    x_avg = x[:, 0].float().mean(dim=-1)  # [B, F]
    assign = _sq_dist(m, c).argmin(dim=1)  # [N] bank item -> cluster
    pc = _sq_dist(x_avg, c).argmin(dim=1)  # [B] query cluster
    order = torch.argsort(-_sq_dist(c, c)[pc], dim=1, stable=True)  # [B, K] farthest first
    rank_of = torch.empty_like(order).scatter_(1, order, torch.arange(k, device=x.device).expand_as(order))
    valid = torch.arange(n, device=x.device) < state.fill
    item_rank = torch.where(valid, rank_of[:, assign], k + 1)  # [B, N]
    eligible = (item_rank == item_rank.min(dim=1, keepdim=True).values) & valid
    eligible &= torch.cumsum(eligible.long(), dim=1) <= top_k
    return torch.where(eligible, gumbel, float("-inf")).argmax(dim=1)


def kmix(state: MixupBankState, x: torch.Tensor, centroids: torch.Tensor, alpha: torch.Tensor,
         rand_index: torch.Tensor, gumbel: torch.Tensor | None, log_domain: bool = True,
         top_k: int = 128) -> torch.Tensor:
    """Mix clip i of ``x [B, C, F, T]`` at weight ``alpha[i]`` (= ratio *
    U(0, 1)) with its Kmix partner (``kmix_partner_index``) once the bank
    holds ``top_k`` items, before that with bank entry ``rand_index[i]``
    (uniform over the filled slots); the identity while the bank is empty."""
    if state.fill == 0:
        return x
    index = kmix_partner_index(state, x, centroids, gumbel, top_k) if state.fill >= top_k else rand_index
    z = state.bank[index].to(x.dtype)[:, None]
    a = alpha.view(-1, 1, 1, 1)
    return log_mixup_exp(x, z, 1.0 - a) if log_domain else a * z + (1.0 - a) * x


def mix_gaussian_noise(x: torch.Tensor, lambd: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """MixGaussianNoise (augmentations.py:193-208): log((1 - l) exp(x) +
    exp(l * noise) + eps), with one weight ``lambd`` (= ratio * U(0, 1)) for
    the view and ``noise`` ~ N(0, 1) of x's shape."""
    return torch.log((1.0 - lambd) * torch.exp(x) + torch.exp(lambd * noise) + EPS32)


def mast_noise(x: torch.Tensor, scale: torch.Tensor, noise: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """MAST fbank noise (extras/mast_new/mast/dataloader.py:205-207): add
    ``noise`` (U(0, 1) of x's shape) times each clip's ``scale`` [B]
    (U(0, 1) / 10), then roll each clip of ``x [B, C, F, T]`` along the time
    axis by its ``shift`` [B] (an integer in [-10, 10): jax.random.randint's
    upper bound is exclusive)."""
    b, t = x.shape[0], x.shape[-1]
    x = x + noise * scale.view(-1, *(1,) * (x.dim() - 1)).to(x.dtype)
    src = (torch.arange(t, device=x.device) - shift.view(-1, 1).to(x.device)) % t  # out[..., i] = x[..., i - s]
    return torch.gather(x, -1, src.view(b, *(1,) * (x.dim() - 2), t).expand_as(x))


def sample_mast_noise(b: int, shape: tuple[int, ...], generator: torch.Generator,
                      max_shift: int = 10) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MAST noise's draws for B clips of ``shape`` [C, F, T], on the
    generator's device: (scale [B], noise [B, C, F, T], shift [B])."""
    dev = generator.device
    scale = torch.rand(b, generator=generator, device=dev) / 10.0
    noise = torch.rand((b, *shape), generator=generator, device=dev)
    shift = torch.randint(-max_shift, max_shift, (b,), generator=generator, device=dev)
    return scale, noise, shift


def sample_gumbel(shape: tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) of u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class ViewDraws(NamedTuple):
    """The random numbers of one view: mixup weight [B] and bank index [B]
    (None without mixup), crop boxes [B, 4] (None without RandomResizeCrop),
    SpecMask spans (None without SpecMask); Kmix's weight [B], uniform
    partner [B] and Gumbel noise [B, bank size] (None until the bank holds
    top_k items), the Gaussian noise's weight [] and draws [B, 1, F, T]
    (None without them), and MAST noise's scale [B], U(0, 1) field [B, 1, F,
    T] and time shift [B] (None without it)."""

    mix_alpha: torch.Tensor | None
    mix_index: torch.Tensor | None
    crop_boxes: torch.Tensor | None
    mask: MaskDraws | None = None
    kmix_alpha: torch.Tensor | None = None
    kmix_index: torch.Tensor | None = None
    kmix_gumbel: torch.Tensor | None = None
    noise_lambda: torch.Tensor | None = None
    noise: torch.Tensor | None = None
    mnoise_scale: torch.Tensor | None = None
    mnoise: torch.Tensor | None = None
    mnoise_shift: torch.Tensor | None = None


@dataclasses.dataclass
class AugmentState:
    mixup: MixupBankState | None
    running_norm: RunningNormState | None


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Parsed from the YAML ``pretrain.augmentations`` + ``pretrain.normalization``
    (the JAX package's fields, so the two parse a config alike)."""

    mixup_ratio: float | None = 0.4
    mixup_log: bool = True
    kmix_ratio: float | None = None
    kmix_log: bool = True
    kmix_top_k: int = 128
    rrc: bool = True
    virtual_crop_scale: tuple[float, float] = (1.0, 1.5)
    freq_scale: tuple[float, float] = (0.6, 1.5)
    time_scale: tuple[float, float] = (0.6, 1.5)
    gaussian_ratio: float | None = None
    spec_mask_freq: int = 0
    spec_mask_time: int = 0
    normalization: str = "mean_var"  # mean_var | l2 | precomputed | none
    norm_mean: float | None = None
    norm_std: float | None = None
    norm_std_mult: float = 2.0
    wave_mixup_rate: float = 0.0
    mast_noise: bool = False
    n_memory: int = 2048

    @classmethod
    def from_dict(cls, pretrain: dict[str, Any]) -> "AugmentConfig":
        aug = pretrain.get("augmentations", {}) or {}
        kw: dict[str, Any] = {"normalization": pretrain.get("normalization", "none")}
        if kw["normalization"] == "precomputed":
            ns = pretrain.get("norm_stats")
            if not ns:
                raise ValueError("normalization: precomputed needs pretrain.norm_stats ({mean, std})")
            mean, std = (ns["mean"], ns["std"]) if isinstance(ns, dict) else tuple(ns)
            kw["norm_mean"], kw["norm_std"] = float(mean), float(std)
            kw["norm_std_mult"] = float(pretrain.get("norm_std_mult", 2.0))
        inp = pretrain.get("input") or {}
        kw["wave_mixup_rate"] = float(inp.get("mixup", 0.0) or 0.0)
        kw["mast_noise"] = bool(inp.get("noise", False))
        if "MixupBYOLA" in aug:
            kw["mixup_ratio"] = float(aug["MixupBYOLA"].get("ratio", 0.4))
            kw["mixup_log"] = bool(aug["MixupBYOLA"].get("log_mixup_exp", True))
        else:
            kw["mixup_ratio"] = None
        cp = (aug.get("Kmix") or {}).get("centroid_path")
        if "Kmix" in aug and cp not in (None, "None"):
            kw["kmix_ratio"] = float(aug["Kmix"].get("ratio", 0.4))
            kw["kmix_log"] = bool(aug["Kmix"].get("log_mixup_exp", True))
            kw["kmix_top_k"] = int(aug["Kmix"].get("top_k", 128))
        if "RandomResizeCrop" in aug:
            r = aug["RandomResizeCrop"]
            kw["rrc"] = True
            kw["virtual_crop_scale"] = tuple(r.get("virtual_crop_scale", (1.0, 1.5)))
            kw["freq_scale"] = tuple(r.get("freq_crop_scale", (0.6, 1.5)))
            kw["time_scale"] = tuple(r.get("time_crop_scale", (0.6, 1.5)))
        else:
            kw["rrc"] = False
        if "MixGaussianNoise" in aug:
            kw["gaussian_ratio"] = float(aug["MixGaussianNoise"].get("ratio", 0.3))
        if "SpecMask" in aug:
            kw["spec_mask_freq"] = int(aug["SpecMask"].get("freq_param", 0))
            kw["spec_mask_time"] = int(aug["SpecMask"].get("time_param", 0))
        return cls(**kw)


class AugmentPipeline:
    """(state, batch [B, 1, F, T], draws) -> (state, view 1, view 2).

    Order as AugmentationModule.get_augmentations: RunningNorm first, then
    view 1, a bank push, view 2 (which can draw view 1's push), a second push.
    A view is mixup, Kmix, Gaussian noise, crop, SpecMask, the precomputed
    norm, then MAST noise: MAST masks THEN normalizes (dataloader.py:186-202),
    so masked bins sit at (0 - mean) / (2 std). Kmix needs ``centroids`` [K,
    n_mels] (make_pseudo_labels --save_centroids); the bank exists when
    mixup or Kmix is on.
    """

    def __init__(self, cfg: AugmentConfig, epoch_samples: int, centroids: np.ndarray | torch.Tensor | None = None):
        if cfg.kmix_ratio is not None and centroids is None:
            raise ValueError("Kmix enabled but no centroids provided")
        self.cfg = cfg
        self.epoch_samples = epoch_samples
        self.centroids = None if centroids is None else torch.as_tensor(centroids, dtype=torch.float32)
        self._ranked_logged = False

    @property
    def has_bank(self) -> bool:
        return self.cfg.mixup_ratio is not None or self.cfg.kmix_ratio is not None

    def init_state(self, n_mels: int, n_frames: int, device: str | torch.device = "cpu") -> AugmentState:
        cfg = self.cfg
        return AugmentState(
            mixup=mixup_bank_init(cfg.n_memory, n_mels, n_frames, device) if self.has_bank else None,
            # the reference caps RunningNorm at 2 * len(csv) samples per epoch: the
            # FIFO sees each clip twice per epoch (two views), __init__.py:14
            running_norm=running_norm_init(2 * self.epoch_samples, device=device)
            if cfg.normalization == "mean_var" else None,
        )

    def sample_draws(self, state: AugmentState, b: int, n_mels: int, n_frames: int,
                     generator: torch.Generator) -> tuple[ViewDraws, ViewDraws]:
        """Both views' draws from ``generator``, on its device. Each view's
        bank indices are uniform over the slots filled when it is made."""
        cfg = self.cfg
        draws = []
        fill = state.mixup.fill if state.mixup is not None else 0
        for _ in range(2):
            alpha = index = boxes = None
            extra: dict[str, torch.Tensor | None] = {}
            dev = generator.device
            if cfg.mixup_ratio is not None:
                alpha = cfg.mixup_ratio * torch.rand(b, generator=generator, device=dev)
                index = torch.randint(0, max(fill, 1), (b,), generator=generator, device=dev)
            if cfg.kmix_ratio is not None:
                extra["kmix_alpha"] = cfg.kmix_ratio * torch.rand(b, generator=generator, device=dev)
                extra["kmix_index"] = torch.randint(0, max(fill, 1), (b,), generator=generator, device=dev)
                if fill >= cfg.kmix_top_k:
                    extra["kmix_gumbel"] = sample_gumbel((b, cfg.n_memory), generator)
            if cfg.gaussian_ratio is not None:
                extra["noise_lambda"] = cfg.gaussian_ratio * torch.rand((), generator=generator, device=dev)
                extra["noise"] = torch.randn((b, 1, n_mels, n_frames), generator=generator, device=dev)
            if self.has_bank:
                fill = min(fill + b, cfg.n_memory)
            if cfg.rrc:
                boxes = sample_crop_boxes(
                    b, n_mels, n_frames, generator, cfg.virtual_crop_scale, cfg.freq_scale, cfg.time_scale
                )
            mask = None
            if cfg.spec_mask_freq or cfg.spec_mask_time:
                mask = sample_mask_draws(b, n_mels, n_frames, cfg.spec_mask_freq, cfg.spec_mask_time, generator)
            if cfg.mast_noise:
                extra["mnoise_scale"], extra["mnoise"], extra["mnoise_shift"] = sample_mast_noise(
                    b, (1, n_mels, n_frames), generator)
            draws.append(ViewDraws(alpha, index, boxes, mask, **extra))
        return draws[0], draws[1]

    def sample_wave_draws(self, b: int, generator: torch.Generator) -> WaveMixDraws | None:
        """The waveform mixup's draws for B clips, or None when it is off."""
        rate = self.cfg.wave_mixup_rate
        return sample_wave_mixup(b, rate, generator) if rate > 0.0 else None

    def _one_view(self, mixup: MixupBankState | None, x: torch.Tensor, draws: ViewDraws) -> torch.Tensor:
        cfg = self.cfg
        if cfg.mixup_ratio is not None:
            x = mixup_byola(mixup, x, draws.mix_alpha, draws.mix_index, cfg.mixup_log)
        if cfg.kmix_ratio is not None:
            if self.centroids.device != x.device:
                self.centroids = self.centroids.to(x.device)
            if mixup.fill >= cfg.kmix_top_k and not self._ranked_logged:
                log.info("Kmix: the bank holds %d items (top_k %d): partners from the ranked centroid "
                         "neighbourhoods from here on", mixup.fill, cfg.kmix_top_k)
                self._ranked_logged = True
            x = kmix(mixup, x, self.centroids, draws.kmix_alpha, draws.kmix_index, draws.kmix_gumbel, cfg.kmix_log,
                     cfg.kmix_top_k)
        if cfg.gaussian_ratio is not None:
            x = mix_gaussian_noise(x, draws.noise_lambda, draws.noise)
        if self.cfg.rrc:
            x = random_resize_crop(x, draws.crop_boxes, self.cfg.virtual_crop_scale)
        if draws.mask is not None:
            x = spec_mask(x, draws.mask)
        if self.cfg.normalization == "precomputed":
            x = precomputed_norm(x, self.cfg.norm_mean, self.cfg.norm_std_mult * self.cfg.norm_std)
        if cfg.mast_noise:
            x = mast_noise(x, draws.mnoise_scale, draws.mnoise, draws.mnoise_shift)
        return x

    def __call__(self, state: AugmentState, x: torch.Tensor, draws: tuple[ViewDraws, ViewDraws]):
        rn = state.running_norm
        if rn is not None:
            rn, x = running_norm_apply(rn, x)
        mix = state.mixup
        v1 = self._one_view(mix, x, draws[0])
        if mix is not None:
            mix = mixup_bank_push(mix, x)
        v2 = self._one_view(mix, x, draws[1])
        if mix is not None:
            mix = mixup_bank_push(mix, x)
        return AugmentState(mixup=mix, running_norm=rn), v1, v2
