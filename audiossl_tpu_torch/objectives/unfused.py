"""UnFuSeD / SSSD: pseudo-label distillation over encoder layer taps (port of
``audiossl_tpu.objectives.unfused``).

Reference behaviour (src/upstream/unfused/upstream_expert.py:126-168): one
encoder (no siamese pair) on view 1; each layer tap goes through a Barlow-
style ``MLPProjector`` sized to the pseudo-label count (``task_label``), in
the compute dtype, and the pooled output through an f32 linear classifier:

    CE   = alpha * sum_i CE(p_i(tap_i), y)  +  CE(classifier(pooled), y)
    KL   = beta  * sum_i KL(log_softmax(p_i) || softmax(classifier))
    MSE  = gamma * sum_i (2 - 2 cos(p_i, classifier))

Labels are DECAR cluster ids from the pretraining manifest's ``label``
column (``labeled``: the loop loads a labelled manifest). ``cross_entropy``
is also the downstream probe's loss.
"""
from __future__ import annotations

from typing import Any

import torch

from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6, max_mean_pool
from audiossl_tpu_torch.models.heads import LinearClassifier, MLPProjector
from audiossl_tpu_torch.objectives.api import Objective, register, sub_state_dict
from audiossl_tpu_torch.objectives.delores_m import TAP_DIMS, tapped_audiontt_kwargs
from audiossl_tpu_torch.ops.stats import l2_normalize


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp(logits) - logits[label] over the batch, in f32."""
    logits = logits.float()
    return (torch.logsumexp(logits, dim=1) - logits.gather(1, labels[:, None].long())[:, 0]).mean()


def kl_batchmean(log_pred: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """``nn.KLDivLoss(reduction='batchmean')``: sum of t (log t − log_pred)
    over entries with t > 0, / B."""
    t = target_probs
    elt = torch.where(t > 0, t * (torch.log(t.clamp_min(1e-20)) - log_pred), 0.0)
    return elt.sum() / log_pred.shape[0]


def cosine_mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The reference's loss_fn_mse: mean(2 − 2 cos) of L2-normalised rows,
    eps 1e-6 as in JAX (a projector row near 0 keeps a bounded gradient)."""
    return (2.0 - 2.0 * (l2_normalize(x, eps=1e-6) * l2_normalize(y, eps=1e-6)).sum(-1)).mean()


class EncoderUnfused(AudioNTT2020Task6):
    """AudioNTT with taps -> (max+mean pooled output, (tap1, tap2, tap3))."""

    def __init__(self, **audiontt):
        super().__init__(return_all_layers=True, **audiontt)

    def forward(self, v: torch.Tensor, generator: torch.Generator | None = None):
        l1, l2, l3, x = super().forward(v, generator)
        return max_mean_pool(x), (l1, l2, l3)


@register("unfused")
class Unfused(Objective):
    labeled = True  # consumes (view, label) batches
    fsdp_units = ("encoder", "p1", "p2", "p3", "classifier")

    def __init__(self, config: dict[str, Any]):
        super().__init__()
        pre = config["pretrain"]
        kw = tapped_audiontt_kwargs(pre, "UnFuSeD")
        self.num_classes = int(pre["task_label"])
        self.alpha = float(pre.get("alpha", 0.7))
        self.beta = float(pre.get("beta", 0.3))
        self.gamma = float(pre.get("gamma", 0.003))
        self.encoder = EncoderUnfused(**kw)
        for i, tap in enumerate(TAP_DIMS, 1):
            self.add_module(f"p{i}", MLPProjector(tap, self.num_classes, self.num_classes,
                                                  compute_dtype=kw["compute_dtype"]))
        self.classifier = LinearClassifier(self.encoder.d, self.num_classes)  # the pooled width (the reference: 2048)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.encoder.compute_dtype

    def loss(self, v1: torch.Tensor, v2: torch.Tensor | None = None, generator: torch.Generator | None = None,
             labels: torch.Tensor | None = None) -> torch.Tensor:
        """CE + KL + MSE of view 1's taps and pooled output against the
        labels (view 2 is not used)."""
        if labels is None:
            raise ValueError("UnFuSeD trains on labelled batches: loss() needs the labels")
        pooled, taps = self.encoder(v1, generator)
        q_clf = self.classifier(pooled)
        tags = [getattr(self, f"p{i}")(t) for i, t in enumerate(taps, 1)]
        loss_ce = self.alpha * sum(cross_entropy(t, labels) for t in tags) + cross_entropy(q_clf, labels)
        targets = torch.softmax(q_clf, dim=1)
        loss_kl = self.beta * sum(kl_batchmean(torch.log_softmax(t, dim=1), targets) for t in tags)
        loss_mse = self.gamma * sum(cosine_mse(t, q_clf) for t in tags)
        return loss_ce + loss_kl + loss_mse

    def export_state_dict(self, sd: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        """The AudioNTT in the reference layout (JAX's ``encoder_variables``),
        from this module or from its (dense) state_dict ``sd``."""
        return self.encoder.state_dict() if sd is None else sub_state_dict(sd, "encoder.")
