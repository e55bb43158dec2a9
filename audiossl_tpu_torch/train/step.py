"""One pretraining step (port of ``audiossl_tpu.train.step``):

    waves -> (int16 decode) -> (l2) -> (waveform mixup) -> frontend ->
    (RunningNorm) + two augmented views -> objective loss -> backward ->
    optimizer step

On the card the log-mel frontend is the Hopper log-mel kernel and the fbank
frontend the dense-rows kernel; block 1 of AudioNTT runs the fused block-1
kernels and MViT's attention the rel-pos attention kernels.

Data parallel across processes (parallel/dist.py), JAX's ``shard_map`` step
over the ``data`` axis: each process takes its share of the global batch
and its own generator (``dist.rank_seed``, for JAX's ``fold_in(key,
axis_index)``); the objectives' collectives (SyncBN, the Barlow all-reduce,
the queue's all-gather) run inside the loss; after the backward, and after
the last microbatch under gradient accumulation, the gradients are
all-reduced as a mean in one flat buffer and the returned loss is the
group's mean (JAX ``pmean`` of gradients and metrics, step.py:127,130).
The augmentation state (mixup bank, RunningNorm) stays per process, as
JAX's ``aug_state`` is sharded over the axis.

Sharded training state over the same axis (``layout``): under ``run.fsdp``
(an ``fsdp.Shards``) the pieces' gradients come out of the gathers already
reduce-scattered as the axis's mean, once per backward (A times a step
under gradient accumulation: the mean of a sum is the sum of the means),
and only the leaves that stay whole take the all-reduce after the last
microbatch; under ``run.zero_optimizer`` (a ``train.zero.ZeroOptimizer``)
nothing is all-reduced here: the optimizer's step reduce-scatters the
gradients and all-gathers the updated slices. The layout's
``grads_to_all_reduce`` says which gradients the step all-reduces. The
returned loss is the axis's mean in every layout.
"""
from __future__ import annotations

import contextlib
import torch
from torch import nn

from audiossl_tpu_torch import no_tf32
from audiossl_tpu_torch.data.augment import AugmentPipeline, AugmentState, ViewDraws
from audiossl_tpu_torch.frontend import FrontendSpec
from audiossl_tpu_torch.frontend.fbank import WaveMixDraws, batch_waveform_mixup
from audiossl_tpu_torch.ops.stats import l2_normalize
from audiossl_tpu_torch.parallel import dist


def prepare_views(
    pipeline: AugmentPipeline,
    frontend: FrontendSpec,
    normalization: str,
    aug_state: AugmentState,
    waves: torch.Tensor,
    draws: tuple[ViewDraws, ViewDraws],
    wave_draws: WaveMixDraws | None = None,
) -> tuple[AugmentState, torch.Tensor, torch.Tensor]:
    """waves [B, L] (f32, or int16 PCM) -> (aug_state', v1, v2), views in the
    reference layout [B, 1, F, T]. ``wave_draws`` are the waveform mixup's
    (needed when the pipeline's ``wave_mixup_rate`` is set)."""
    if waves.dtype == torch.int16:  # the loader's PCM16 wire format
        waves = waves.float() / 32768.0
    if normalization == "l2":
        waves = l2_normalize(waves, dim=-1)
    if pipeline.cfg.wave_mixup_rate > 0.0:
        if wave_draws is None:
            raise ValueError("the waveform mixup is on (pretrain.input.mixup) but no draws were given")
        waves = batch_waveform_mixup(waves, wave_draws)
    lms = frontend(waves)[:, None]
    return pipeline(aug_state, lms, draws)


class TrainStep:
    """``step(aug_state, waves, labels=None) -> (aug_state', loss)``: views,
    loss, backward and one optimizer (and scheduler) step. ``labels`` (the
    ids of a labelled batch, on the waves' device) go to the objective's
    loss. The views' random numbers and the dropout masks come from
    ``generator``; an f32 objective runs forward and backward with TF32 off.
    Across processes the gradients and the loss are the group's means;
    ``layout`` (fsdp's ``Shards`` or a ``ZeroOptimizer``) picks the
    gradients the step all-reduces, None every parameter's."""

    def __init__(
        self,
        objective: nn.Module,
        pipeline: AugmentPipeline,
        frontend: FrontendSpec,
        optimizer: torch.optim.Optimizer,
        generator: torch.Generator,
        scheduler: torch.optim.lr_scheduler.LRScheduler | None = None,
        normalization: str = "mean_var",
        layout=None,
    ):
        self.objective = objective
        self.pipeline = pipeline
        self.frontend = frontend
        self.optimizer = optimizer
        self.generator = generator
        self.scheduler = scheduler
        self.normalization = normalization
        self.layout = layout

    def views(self, aug_state: AugmentState, waves: torch.Tensor):
        b = waves.shape[0]
        wave_draws = self.pipeline.sample_wave_draws(b, self.generator)
        n_frames = self.frontend.num_frames(waves.shape[-1])
        draws = self.pipeline.sample_draws(aug_state, b, self.frontend.n_mels, n_frames, self.generator)
        return prepare_views(self.pipeline, self.frontend, self.normalization, aug_state, waves, draws, wave_draws)

    def loss_and_grads(self, v1: torch.Tensor, v2: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
        f32 = self.objective.compute_dtype == torch.float32
        with no_tf32() if f32 else contextlib.nullcontext():
            if hasattr(self.objective, "loss_and_backward"):  # an objective that runs its own backward (SS-MAST)
                self.optimizer.zero_grad(set_to_none=True)
                loss = self.objective.loss_and_backward(v1, v2, self.generator, labels=labels)
            else:
                loss = self.objective.loss(v1, v2, self.generator, labels=labels)
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
        self.reduce_grads()
        return dist.all_reduce_mean(loss.detach())

    def reduce_grads(self) -> None:
        """The data axis's mean of the gradients the layout leaves to the step."""
        params = list(self.objective.parameters())
        dist.all_reduce_grads_(params if self.layout is None else self.layout.grads_to_all_reduce(params))

    def update(self) -> None:
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def __call__(self, aug_state: AugmentState, waves: torch.Tensor,
                 labels: torch.Tensor | None = None) -> tuple[AugmentState, torch.Tensor]:
        aug_state, v1, v2 = self.views(aug_state, waves)
        loss = self.loss_and_grads(v1, v2, labels)
        self.update()
        return aug_state, loss
