"""Objective registry (port of ``audiossl_tpu.objectives.api``).

An objective of the port is an ``Objective``: an ``nn.Module`` that owns its
encoder and heads and computes the SSL loss of two views:
``loss(v1, v2, generator, labels=None)``, with BatchNorm running statistics
(and a MoCo objective's key encoder and queue) updated as a side effect of
the forward. ``labels`` are the per-clip ids of a labelled batch, which only
an objective whose class sets ``labeled`` reads (UnFuSeD); the loop loads a
labelled manifest for it. ``export_state_dict()`` is what
``train/checkpoint.py`` exports for serving and downstream use;
``export_state_dict(sd)`` takes it from a (dense) state_dict instead, as
``run.fsdp``'s save does. Under ``run.fsdp`` (parallel/fsdp.py) an
objective's ``fsdp_units`` are the modules gathered around their forward,
its ``fsdp_buffers`` the root buffers sharded with the parameters, and
``fsdp_shards`` the layout once it is sharded.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn


class Objective(nn.Module):
    labeled = False  # True: loss() takes the labels of a labelled manifest
    fsdp_units: tuple[str, ...] = ()
    fsdp_buffers: tuple[str, ...] = ()
    fsdp_shards = None  # parallel/fsdp.py Shards, once the objective is sharded

    def _whole(self, name: str) -> torch.Tensor:
        """The root buffer ``name`` whole (a gather under fsdp when it is sharded)."""
        return getattr(self, name) if self.fsdp_shards is None else self.fsdp_shards.whole(name)

    def _mine(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """What this rank keeps of a whole value of buffer ``name``."""
        return whole if self.fsdp_shards is None else self.fsdp_shards.mine(name, whole)


def sub_state_dict(sd: dict[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    """The entries of ``sd`` under ``prefix``, the prefix taken off."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


_REGISTRY: dict[str, Callable[..., Objective]] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def objective_class(name: str) -> type[Objective]:
    """The registered class of ``name`` (its ``labeled`` flag says which
    manifest the loop loads)."""
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"upstream objective {name!r} is not ported (ported: {sorted(_REGISTRY)}; DeepCluster-v1, "
            "--upstream decar_v1, has a trainer of its own, train/deepcluster_loop.py)"
        )
    return _REGISTRY[name]


def get_objective(name: str, config: dict[str, Any], **kwargs) -> Objective:
    """The objective ``name`` built from an experiment config."""
    return objective_class(name)(config, **kwargs)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init: a normal of variance 1/fan_in truncated at
    two standard deviations (std corrected for the truncation)."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisation of ``module`` in place, drawn from
    ``generator``: lecun-normal dense and conv kernels (depthwise ones
    included), zero biases, BatchNorm and LayerNorm at identity, rel-pos
    tables truncated-normal with std 0.02 (cut at two std)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                _lecun_normal_(m.weight, m.weight[0].numel(), generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                if m.affine:
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for name, p in module.named_parameters():
            if name.endswith((".rel_pos_h", ".rel_pos_w")):
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=generator)


def init_objective(name: str, config: dict[str, Any], seed: int, device: str | torch.device = "cpu") -> Objective:
    """``get_objective`` with ``flax_init_`` drawn from
    ``torch.Generator().manual_seed(seed)``, then the objective's own
    ``init_state_`` (the MoCo objectives: the key encoder and the queue).
    The modules are built on the meta device first, so no draw touches the
    global generator."""
    with torch.device("meta"):
        obj = get_objective(name, config)
    obj = obj.to_empty(device="cpu")
    g = torch.Generator().manual_seed(seed)
    flax_init_(obj, g)
    if hasattr(obj, "init_state_"):
        with torch.no_grad():
            obj.init_state_(g)
    return obj.to(device)
