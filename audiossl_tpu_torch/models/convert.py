"""Carry weights across: JAX/flax variables -> the port's state_dicts.

The port's own copies of ``audiossl_tpu.models.torch_export``'s
``audiontt_to_torch`` and ``projection_to_torch`` (the port imports nothing
of the JAX package), so the whole DeLoRes-S trainer state, encoder and
projector, carries over. Conventions bridged:

* flax HWIO conv kernels, spatial (time, freq) -> torch OIHW, (freq, time):
  the JAX encoder runs time-major, the reference and the port freq-major;
* flax Dense [in, out] -> torch Linear [out, in];
* flax BatchNorm scale/bias + batch_stats mean/var -> BatchNorm2d
  weight/bias/running_mean/running_var.

``audiontt_from_flax`` takes the encoder's variables as NumPy arrays
(``{"params": ..., "batch_stats": ...}`` with ``ConvBlock_{0,1,2}`` and
``Dense_{0,1}``), e.g. ``jax.tree.map(np.asarray, variables)``; its output
loads into ``models.audiontt.AudioNTT2020Task6`` with ``strict=True``.
``projection_from_flax`` takes the projector's params and batch_stats; its
output loads into ``models.heads.MLPProjector``. ``delores_m_from_flax``,
``slicer_from_flax`` and ``unfused_from_flax`` take a JAX objective's whole
state, (params, batch_stats, ssl_state), and return the port objective's
whole state_dict: encoders, heads, running statistics, key encoder and queue.
``decar_from_flax`` takes a JAX ``DecarV2``'s (params, batch_stats) and
returns the port ``DecarV2``'s state_dict (``net.`` + encoder, proj_fc1,
proj_bn, proj_fc2, prototypes{i}); ``deepcluster_from_flax`` takes the JAX
DeepCluster-v1 trainer's (params, batch_stats), ``encoder`` and
``top_layer``, and returns ``train.deepcluster_loop.DeepClusterNet``'s.

``ast_from_flax`` is the inverse of ``ast_to_torch`` into the port's own
time-major AST (timm naming, the flax q / k / v Dense layers fused into one
head-major ``qkv``); ``ast_reference_layout`` writes the reference's
freq-major order from it, which is what ``ast_to_torch`` writes.

``mast_from_flax`` is the port's copy of ``mast_to_torch``: MAST trunk
variables -> the reference's flat ``blocks.{i}`` MViTv2 state_dict, which
runs freq-major. The port's MViT runs time-major, as the JAX module does;
``mvit_reference_layout`` converts a state_dict either way (it is its own
inverse): the patch and pooling conv kernels transpose their spatial axes
and rel_pos_h / rel_pos_w swap.

``efficientnet_from_flax`` carries the JAX EfficientNet-B0 (which has no
exporter) into ``models.efficientnet.EfficientNetB0``'s efficientnet_pytorch
names; both run freq-major, so only the kernels' axis order changes.

Checkpoints and serving artifacts hold every encoder in the reference
layout; ``port_layout`` and ``reference_layout`` convert a state_dict of
any encoder type between that and the port's modules.

``shard_state_dict`` cuts a state_dict into one rank's tensor-parallel
shards, for both encoders, under ``parallel.tp_ast.ast_spec`` or
``parallel.tp_mvit.mvit_spec`` (a resume at tp > 1 loads the dense
checkpoint through it): after ``ast_from_flax`` / ``mast_from_flax``, rank
t's shard equals JAX's addressable shard t of the same tree under
``ast_tp_specs`` / ``mvit_tp_specs``; ``parallel.tp.gather`` joins the
shards back (``dense_state_dict`` across the ranks).

``aug_state_from_flax`` / ``aug_state_to_flax`` carry JAX's world-sized
augmentation state (``P(DATA_AXIS)``: one mixup bank and RunningNorm a
device) to the port checkpoint's world-sized layout (one a process) and
back, so that both sides of a data-parallel test start from one state.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # an owned, writable copy


def audiontt_from_flax(variables_numpy: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """AudioNTT2020Task6 flax variables -> reference-layout torch state_dict
    (``features_{1,2,3}.{0: Conv2d, 1: BatchNorm2d}``, ``fc.{0, 3}``)."""
    params = variables_numpy["params"]
    batch_stats = variables_numpy.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    for i in range(3):
        blk, bs = params[f"ConvBlock_{i}"], batch_stats[f"ConvBlock_{i}"]
        t = f"features_{i + 1}"
        # HWIO (time, freq, in, out) -> OIHW (out, in, freq, time)
        sd[f"{t}.0.weight"] = _t(np.transpose(np.asarray(blk["Conv_0"]["kernel"]), (3, 2, 1, 0)))
        sd[f"{t}.0.bias"] = _t(blk["Conv_0"]["bias"])
        sd[f"{t}.1.weight"] = _t(blk["BatchNorm_0"]["scale"])
        sd[f"{t}.1.bias"] = _t(blk["BatchNorm_0"]["bias"])
        sd[f"{t}.1.running_mean"] = _t(bs["BatchNorm_0"]["mean"])
        sd[f"{t}.1.running_var"] = _t(bs["BatchNorm_0"]["var"])
        sd[f"{t}.1.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    for j, t in ((0, "fc.0"), (1, "fc.3")):
        dense = params[f"Dense_{j}"]
        sd[f"{t}.weight"] = _t(np.asarray(dense["kernel"]).T)
        sd[f"{t}.bias"] = _t(dense["bias"])
    return sd


def projection_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``MLPProjector`` flax params and batch_stats -> the reference Barlow
    ``Projection`` state_dict (``projector.{0,3,6}`` bias-free Linears,
    ``projector.{1,4}`` BatchNorm1d, and the affine-free ``bn`` at its
    initial state), which ``models.heads.MLPProjector`` loads."""
    sd: dict[str, torch.Tensor] = {}
    for dense_idx, torch_idx in ((0, 0), (1, 3), (2, 6)):
        sd[f"projector.{torch_idx}.weight"] = _t(np.asarray(params[f"Dense_{dense_idx}"]["kernel"]).T)
    for bn_idx, torch_idx in ((0, 1), (1, 4)):
        p, s = params[f"BatchNorm_{bn_idx}"], batch_stats[f"BatchNorm_{bn_idx}"]
        sd[f"projector.{torch_idx}.weight"] = _t(p["scale"])
        sd[f"projector.{torch_idx}.bias"] = _t(p["bias"])
        sd[f"projector.{torch_idx}.running_mean"] = _t(s["mean"])
        sd[f"projector.{torch_idx}.running_var"] = _t(s["var"])
        sd[f"projector.{torch_idx}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    out_dim = np.asarray(params["Dense_2"]["kernel"]).shape[1]
    sd["bn.running_mean"] = torch.zeros(out_dim, dtype=torch.float32)
    sd["bn.running_var"] = torch.ones(out_dim, dtype=torch.float32)
    sd["bn.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


def dense_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A flax ``Dense`` (kernel [in, out], bias) -> ``nn.Linear``'s weight and bias."""
    sd = {"weight": _t(np.asarray(tree["kernel"]).T)}
    if "bias" in tree:
        sd["bias"] = _t(tree["bias"])
    return sd


def _prefixed(prefix: str, sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _audiontt(params: Mapping[str, Any], batch_stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The AudioNTT one level inside an objective's encoder wrapper."""
    return audiontt_from_flax({"params": params["encoder"], "batch_stats": batch_stats["encoder"]})


def _moco_state(ssl_state: Any, encoder) -> dict[str, torch.Tensor]:
    """JAX's ``MocoState`` (params_k, batch_stats_k, queue, queue_ptr) ->
    the key encoder (through ``encoder``, the wrapper's converter), the
    queue and its pointer."""
    params_k, batch_stats_k, queue, ptr = ssl_state
    return {**_prefixed("encoder_k", encoder(params_k, batch_stats_k)), "queue": _t(queue),
            "queue_ptr": torch.tensor(int(np.asarray(ptr)), dtype=torch.long)}


def _projectors(params: Mapping[str, Any], batch_stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    sd = {}
    for i in (1, 2, 3):
        sd.update(_prefixed(f"p{i}", projection_from_flax(params[f"p{i}"], batch_stats[f"p{i}"])))
    return sd


def delores_m_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                        ssl_state: Any) -> dict[str, torch.Tensor]:
    """JAX ``DeloresM`` state (NumPy) -> the whole state_dict of
    ``objectives.delores_m.DeloresM``: query and key ``EncoderM`` (AudioNTT
    + ``fc``), the projectors ``p1``–``p3`` with their running statistics,
    the queue and its pointer."""
    def encoder(p, bs):
        return {**_prefixed("encoder", _audiontt(p, bs)), **_prefixed("fc", dense_from_flax(p["fc"]))}

    return {**_prefixed("encoder", encoder(params["encoder"], batch_stats["encoder"])),
            **_projectors(params, batch_stats), **_moco_state(ssl_state, encoder)}


def slicer_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                     ssl_state: Any) -> dict[str, torch.Tensor]:
    """JAX ``Slicer`` state (NumPy) -> the whole state_dict of
    ``objectives.slicer.Slicer``: query and key ``EncoderSlicer`` (AudioNTT,
    the instance head, the cluster head's two Linears), the queue and its
    pointer."""
    def encoder(p, bs):
        clus = p["cluster_projector"]
        return {**_prefixed("encoder", _audiontt(p, bs)),
                **_prefixed("instance_projector", dense_from_flax(p["instance_projector"])),
                **_prefixed("cluster_projector.0", dense_from_flax(clus["Dense_0"])),
                **_prefixed("cluster_projector.2", dense_from_flax(clus["Dense_1"]))}

    return {**_prefixed("encoder", encoder(params["encoder"], batch_stats["encoder"])),
            **_moco_state(ssl_state, encoder)}


def unfused_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                      ssl_state: Any = ()) -> dict[str, torch.Tensor]:
    """JAX ``Unfused`` state (NumPy; it has no SSL state) -> the whole
    state_dict of ``objectives.unfused.Unfused``: the AudioNTT, the
    projectors ``p1``–``p3`` with their running statistics, the classifier."""
    return {**_prefixed("encoder", _audiontt(params["encoder"], batch_stats["encoder"])),
            **_projectors(params, batch_stats), **_prefixed("classifier", dense_from_flax(params["classifier"]))}


def decar_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``DecarV2`` params and batch_stats (NumPy) -> the state_dict of
    ``objectives.decar.DecarV2``."""
    bn, stats = params["proj_bn"], batch_stats["proj_bn"]
    sd = {**_prefixed("encoder", _audiontt(params, batch_stats)),
          **_prefixed("proj_fc1", dense_from_flax(params["proj_fc1"])),
          "proj_bn.weight": _t(bn["scale"]), "proj_bn.bias": _t(bn["bias"]),
          "proj_bn.running_mean": _t(stats["mean"]), "proj_bn.running_var": _t(stats["var"]),
          "proj_bn.num_batches_tracked": torch.zeros((), dtype=torch.long),
          **_prefixed("proj_fc2", dense_from_flax(params["proj_fc2"]))}
    i = 0
    while f"prototypes{i}" in params:
        sd.update(_prefixed(f"prototypes{i}", dense_from_flax(params[f"prototypes{i}"])))
        i += 1
    return _prefixed("net", sd)


def deepcluster_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX DeepCluster-v1 trainer's params and batch_stats (NumPy:
    ``encoder`` and ``top_layer``) -> ``DeepClusterNet``'s state_dict."""
    return {**_prefixed("encoder", _audiontt(params, batch_stats)),
            **_prefixed("top_layer", dense_from_flax(params["top_layer"]))}


def mast_from_flax(variables_numpy: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``MASTEncoder`` flax variables (``{"params": {"mvit": ...}}``) ->
    the reference MViTv2 state_dict, as ``mast_to_torch`` writes it."""
    mvit = variables_numpy["params"]["mvit"]
    freq_major = lambda w: _t(np.transpose(np.asarray(w), (3, 2, 1, 0)))  # HWIO (time, freq) -> OIHW (freq, time)
    sd: dict[str, torch.Tensor] = {
        "patch_embed.proj.weight": freq_major(mvit["patch_embed"]["kernel"]),
        "patch_embed.proj.bias": _t(mvit["patch_embed"]["bias"]),
    }

    def put_ln(key: str, tree: Mapping[str, Any]) -> None:
        sd[f"{key}.weight"] = _t(tree["scale"])
        sd[f"{key}.bias"] = _t(tree["bias"])

    def put_dense(key: str, tree: Mapping[str, Any]) -> None:
        sd[f"{key}.weight"] = _t(np.asarray(tree["kernel"]).T)
        if "bias" in tree:
            sd[f"{key}.bias"] = _t(tree["bias"])

    i = 0
    while f"block{i}" in mvit:
        blk, b = mvit[f"block{i}"], f"blocks.{i}"
        put_ln(f"{b}.norm1", blk["norm1"])
        put_ln(f"{b}.norm2", blk["norm2"])
        attn = blk["attn"]
        put_dense(f"{b}.attn.qkv", attn["qkv"])
        put_dense(f"{b}.attn.proj", attn["proj"])
        for pool in ("q", "k", "v"):
            if f"pool_{pool}" in attn:
                sd[f"{b}.attn.pool_{pool}.weight"] = freq_major(attn[f"pool_{pool}"]["Conv_0"]["kernel"])
                put_ln(f"{b}.attn.norm_{pool}", attn[f"pool_{pool}"]["LayerNorm_0"])
        if "rel_pos_h" in attn:  # the time-major tables swap back to freq-major H
            sd[f"{b}.attn.rel_pos_h"] = _t(attn["rel_pos_w"])
            sd[f"{b}.attn.rel_pos_w"] = _t(attn["rel_pos_h"])
        if "proj" in blk:
            put_dense(f"{b}.proj", blk["proj"])
        put_dense(f"{b}.mlp.fc1", blk["mlp"]["Dense_0"])
        put_dense(f"{b}.mlp.fc2", blk["mlp"]["Dense_1"])
        i += 1
    if i == 0:
        raise KeyError("no MViT blocks found (expected params['mvit']['block0'])")
    return sd


def mvit_reference_layout(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The port's time-major MViT state_dict <-> the reference's freq-major one."""
    out = {}
    for key, v in sd.items():
        if key.endswith(("patch_embed.proj.weight", ".attn.pool_q.weight", ".attn.pool_k.weight", ".attn.pool_v.weight")):
            v = v.transpose(-1, -2).contiguous()
        elif key.endswith(".attn.rel_pos_h"):
            key = key[: -len("h")] + "w"
        elif key.endswith(".attn.rel_pos_w"):
            key = key[: -len("w")] + "h"
        out[key] = v
    return out


def mast_with_head_from_flax(params_numpy: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``MASTWithHead`` flax params (``{"mast": {"mvit": ...}, "mlp_fc1": ...}``)
    -> the port's ``models.mast.MASTWithHead`` state_dict."""
    trunk = mvit_reference_layout(mast_from_flax({"params": params_numpy["mast"]}))
    sd = {f"mast.{k}": v for k, v in trunk.items()}
    sd["mlp_fc1.weight"] = _t(np.asarray(params_numpy["mlp_fc1"]["kernel"]).T)
    sd["mlp_fc1.bias"] = _t(params_numpy["mlp_fc1"]["bias"])
    return sd


def mast_classifier_from_flax(params_numpy: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``MASTClassifier`` flax params (``{"mast": {"mvit": ...}, "head_norm":
    ..., "head": ...}``) -> the port's ``train.finetune_mast.MASTClassifier``
    state_dict, every key of which it fills (load it strictly)."""
    extra = set(params_numpy) - {"mast", "head_norm", "head"}
    if extra:
        raise ValueError(f"unexpected MASTClassifier params {sorted(extra)}")
    trunk = mvit_reference_layout(mast_from_flax({"params": params_numpy["mast"]}))
    sd = {f"mast.{k}": v for k, v in trunk.items()}
    sd["head_norm.weight"] = _t(params_numpy["head_norm"]["scale"])
    sd["head_norm.bias"] = _t(params_numpy["head_norm"]["bias"])
    sd["head.weight"] = _t(np.asarray(params_numpy["head"]["kernel"]).T)
    sd["head.bias"] = _t(params_numpy["head"]["bias"])
    return sd


def ast_from_flax(variables_numpy: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``ASTEncoder`` flax variables -> the port's ``models.ast.ASTEncoder``
    state_dict: time-major like the JAX module (the patch conv's kernel
    [C, 1, time, freq], the positional embedding row-major over (time,
    freq)), in timm's names."""
    params = variables_numpy["params"]
    sd: dict[str, torch.Tensor] = {
        # HWIO (time, freq, 1, C) -> OIHW (C, 1, time, freq)
        "patch_embed.proj.weight": _t(np.transpose(np.asarray(params["patch_embed"]["kernel"]), (3, 2, 0, 1))),
        "patch_embed.proj.bias": _t(params["patch_embed"]["bias"]),
        "cls_token": _t(params["cls_token"]),
        "dist_token": _t(params["dist_token"]),
        "pos_embed": _t(params["pos_embed"]),
        "norm.weight": _t(params["norm"]["scale"]),
        "norm.bias": _t(params["norm"]["bias"]),
    }
    heads_out = lambda k: np.asarray(k).reshape(np.shape(k)[0], -1).T  # [D_in, H, Dh] -> [H * Dh, D_in]
    i = 0
    while f"block{i}" in params:
        blk, b = params[f"block{i}"], f"blocks.{i}"
        attn = blk["MultiHeadDotProductAttention_0"]
        sd[f"{b}.attn.qkv.weight"] = _t(np.concatenate([heads_out(attn[n]["kernel"]) for n in ("query", "key", "value")]))
        sd[f"{b}.attn.qkv.bias"] = _t(np.concatenate([np.asarray(attn[n]["bias"]).reshape(-1) for n in ("query", "key", "value")]))
        out = np.asarray(attn["out"]["kernel"])  # [H, Dh, D]
        sd[f"{b}.attn.proj.weight"] = _t(out.reshape(-1, out.shape[-1]).T)
        sd[f"{b}.attn.proj.bias"] = _t(attn["out"]["bias"])
        for j, norm in enumerate(("norm1", "norm2")):
            sd[f"{b}.{norm}.weight"] = _t(blk[f"LayerNorm_{j}"]["scale"])
            sd[f"{b}.{norm}.bias"] = _t(blk[f"LayerNorm_{j}"]["bias"])
        for j, fc in enumerate(("fc1", "fc2")):
            sd[f"{b}.mlp.{fc}.weight"] = _t(np.asarray(blk[f"Dense_{j}"]["kernel"]).T)
            sd[f"{b}.mlp.{fc}.bias"] = _t(blk[f"Dense_{j}"]["bias"])
        i += 1
    if i == 0:
        raise KeyError("no transformer blocks found (expected params['block0'])")
    return sd


def vit_block_from_jax(block: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """One block of ``audiossl_tpu.parallel.ring.init_long_ast_params`` (the
    keys ``parallel.pipeline.vit_block`` reads: ln1, qkv, proj, ln2, fc1,
    fc2; Dense kernels [in, out]) -> ``models.ast.ViTBlock``'s state_dict."""
    names = {"ln1": "norm1", "qkv": "attn.qkv", "proj": "attn.proj", "ln2": "norm2", "fc1": "mlp.fc1",
             "fc2": "mlp.fc2"}
    sd = {}
    for jax_key, port in names.items():
        p = block[jax_key]
        if "scale" in p:
            sd[f"{port}.weight"] = _t(p["scale"])
        else:
            sd[f"{port}.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[f"{port}.bias"] = _t(p["bias"])
    return sd


def long_ast_from_jax(params_numpy: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``init_long_ast_params``'s tree (NumPy leaves) -> the port's
    ``parallel.ring.LongAST`` state_dict."""
    sd = {"patch.weight": _t(np.asarray(params_numpy["patch"]["kernel"]).T),
          "patch.bias": _t(params_numpy["patch"]["bias"]), "pos": _t(params_numpy["pos"]),
          "norm.weight": _t(params_numpy["norm"]["scale"]), "norm.bias": _t(params_numpy["norm"]["bias"])}
    for i, blk in enumerate(params_numpy["blocks"]):
        sd.update(_prefixed(f"blocks.{i}", vit_block_from_jax(blk)))
    if "head" in params_numpy:
        sd["head.weight"] = _t(np.asarray(params_numpy["head"]["kernel"]).T)
        sd["head.bias"] = _t(params_numpy["head"]["bias"])
    return sd


def moe_from_jax(params_numpy: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``audiossl_tpu.parallel.moe.init_moe_params``'s dict (NumPy leaves)
    -> the port's whole MoE parameters (the same layout: router [d, E],
    w1 [E, d, h], b1 [E, h], w2 [E, h, d], b2 [E, d]);
    ``parallel.moe.expert_shard`` takes a rank's part."""
    return {k: _t(params_numpy[k]) for k in ("router", "w1", "b1", "w2", "b2")}


def ast_reference_layout(sd: Mapping[str, torch.Tensor], grid_ft: tuple[int, int]) -> dict[str, torch.Tensor]:
    """The port's time-major AST state_dict -> the reference's freq-major one
    (``ast_to_torch``'s output): the patch conv's kernel [C, 1, freq, time],
    and the positional embedding's grid tokens reordered from (time, freq) to
    (freq, time); ``grid_ft`` is the (freq, time) patch grid."""
    f, t = grid_ft
    out = dict(sd)
    out["patch_embed.proj.weight"] = sd["patch_embed.proj.weight"].transpose(-1, -2).contiguous()
    pos = sd["pos_embed"]
    if pos.shape[1] - 2 != f * t:
        raise ValueError(f"grid_ft {grid_ft} != {pos.shape[1] - 2} grid tokens")
    grid = pos[:, 2:].reshape(1, t, f, -1).transpose(1, 2).reshape(1, f * t, -1)
    out["pos_embed"] = torch.cat([pos[:, :2], grid], dim=1).contiguous()
    return out


def ast_port_layout(sd: Mapping[str, torch.Tensor], grid_ft: tuple[int, int]) -> dict[str, torch.Tensor]:
    """The inverse of ``ast_reference_layout``: the reference's freq-major
    AST state_dict -> the port's time-major one; ``grid_ft`` is the (freq,
    time) patch grid the state_dict was made at."""
    if grid_ft is None:
        raise ValueError("an AST state_dict in the reference layout needs the (freq, time) grid of its positional "
                         "embedding to be turned into the port's layout")
    f, t = grid_ft
    out = dict(sd)
    out["patch_embed.proj.weight"] = sd["patch_embed.proj.weight"].transpose(-1, -2).contiguous()
    pos = sd["pos_embed"]
    if pos.shape[1] - 2 != f * t:
        raise ValueError(f"grid_ft {grid_ft} != {pos.shape[1] - 2} grid tokens")
    grid = pos[:, 2:].reshape(1, f, t, -1).transpose(1, 2).reshape(1, f * t, -1)
    out["pos_embed"] = torch.cat([pos[:, :2], grid], dim=1).contiguous()
    return out


def port_layout(sd: Mapping[str, torch.Tensor], encoder_type: str,
                grid_ft: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
    """A reference-layout encoder state_dict (a checkpoint's ``encoder/<step>.pt``,
    an artifact's weights) -> the port module's layout. MAST transposes its
    conv kernels and swaps its rel-pos tables; AST transposes its patch
    kernel and reorders its positional embedding from the (freq, time) grid
    ``grid_ft``; AudioNTT and EfficientNet are the same in both."""
    if encoder_type == "MAST":
        return mvit_reference_layout(sd)
    if encoder_type == "AST":
        return ast_port_layout(sd, grid_ft)
    return dict(sd)


def reference_layout(sd: Mapping[str, torch.Tensor], encoder_type: str,
                     grid_ft: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
    """The inverse of ``port_layout`` (``grid_ft`` is needed for AST)."""
    if encoder_type == "MAST":
        return mvit_reference_layout(sd)
    if encoder_type == "AST":
        return ast_reference_layout(sd, grid_ft)
    return dict(sd)


def shard_state_dict(sd: Mapping[str, torch.Tensor], spec_of: Callable[[str], Any], tp_rank: int,
                     tp: int) -> dict[str, torch.Tensor]:
    """Rank ``tp_rank``'s shards of ``sd``; ``spec_of(key)`` is the key's
    spec (dim, groups), or None for a replicated tensor, which is kept whole
    (``tp_mvit.mvit_spec``, ``tp_ast.ast_spec``)."""
    from audiossl_tpu_torch.parallel.tp import piece

    return {k: v if spec_of(k) is None else piece(v, spec_of(k), tp_rank, tp) for k, v in sd.items()}


def efficientnet_from_flax(variables_numpy: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``EfficientNetB0`` flax variables (``{"params", "batch_stats"}`` of
    the module itself) -> ``models.efficientnet.EfficientNetB0``'s
    state_dict. flax HWIO kernels, spatial (freq, time) as the port's, ->
    OIHW; BatchNorm scale / bias / mean / var -> weight / bias /
    running_mean / running_var."""
    params = variables_numpy["params"]
    stats = variables_numpy.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    oihw = lambda k: _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))

    def put_conv(key: str, tree: Mapping[str, Any]) -> None:
        sd[f"{key}.weight"] = oihw(tree["kernel"])
        if "bias" in tree:
            sd[f"{key}.bias"] = _t(tree["bias"])

    def put_bn(key: str, p: Mapping[str, Any], s: Mapping[str, Any]) -> None:
        sd[f"{key}.weight"] = _t(p["scale"])
        sd[f"{key}.bias"] = _t(p["bias"])
        sd[f"{key}.running_mean"] = _t(s["mean"])
        sd[f"{key}.running_var"] = _t(s["var"])
        sd[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)

    put_conv("_conv_stem", params["stem_conv"])
    put_bn("_bn0", params["stem_bn"], stats["stem_bn"])
    names = sorted((k for k in params if k.startswith("block")),
                   key=lambda k: tuple(int(n) for n in k[len("block"):].split("_")))
    for i, name in enumerate(names):
        p, s, b = params[name], stats[name], f"_blocks.{i}"
        if "expand_conv" in p:
            put_conv(f"{b}._expand_conv", p["expand_conv"])
            put_bn(f"{b}._bn0", p["bn0"], s["bn0"])
        put_conv(f"{b}._depthwise_conv", p["depthwise_conv"])
        put_bn(f"{b}._bn1", p["bn1"], s["bn1"])
        put_conv(f"{b}._se_reduce", p["se"]["Conv_0"])
        put_conv(f"{b}._se_expand", p["se"]["Conv_1"])
        put_conv(f"{b}._project_conv", p["project_conv"])
        put_bn(f"{b}._bn2", p["bn2"], s["bn2"])
    if not names:
        raise KeyError("no MBConv blocks found (expected params['block0_0'])")
    put_conv("_conv_head", params["head_conv"])
    put_bn("_bn1", params["head_bn"], stats["head_bn"])
    return sd


def aug_state_from_flax(aug_state: Any) -> dict[str, Any]:
    """JAX's world-sized augmentation state (``AugmentState`` sharded as
    ``P(DATA_AXIS)``: every leaf with a leading dim of the mesh's size, as
    NumPy arrays or anything ``np.asarray`` takes) -> the port checkpoint's
    world-sized ``augment`` entry (train/loop.py:world_aug_state): the bank
    in bf16, the counts int64, the RunningNorm moments f32, and ``world``."""
    out: dict[str, Any] = {}
    world = None
    if aug_state.mixup is not None:
        m = aug_state.mixup
        bank = torch.from_numpy(np.asarray(m.bank, np.float32)).to(torch.bfloat16)
        world = bank.shape[0]
        out["mixup"] = {"bank": bank, "fill": torch.from_numpy(np.asarray(m.fill, np.int64)),
                        "ptr": torch.from_numpy(np.asarray(m.ptr, np.int64))}
    if aug_state.running_norm is not None:
        rn = aug_state.running_norm
        out["running_norm"] = {"n": torch.from_numpy(np.asarray(rn.n, np.int64)),
                               "mean": torch.from_numpy(np.asarray(rn.mean, np.float32)),
                               "var": torch.from_numpy(np.asarray(rn.var, np.float32)),
                               "max_update": torch.from_numpy(np.asarray(rn.max_update, np.int64))}
        world = out["running_norm"]["n"].shape[0]
    if world is None:
        raise ValueError("an augmentation state with neither a mixup bank nor RunningNorm carries no world size")
    return {"world": int(world), **out}


def aug_state_to_flax(augment: Mapping[str, Any]) -> dict[str, dict[str, np.ndarray]]:
    """The inverse: a world-sized ``augment`` entry -> ``{"mixup": {bank
    (f32), fill, ptr (int32)}, "running_norm": {n, mean, var, max_update}}``
    of NumPy arrays with the leading world dim, the fields of JAX's
    ``MixupBankState`` and ``RunningNormState`` (cast the bank to bf16 there)."""
    out: dict[str, dict[str, np.ndarray]] = {}
    if "mixup" in augment:
        m = augment["mixup"]
        out["mixup"] = {"bank": m["bank"].float().numpy(), "fill": m["fill"].numpy().astype(np.int32),
                        "ptr": m["ptr"].numpy().astype(np.int32)}
    if "running_norm" in augment:
        rn = augment["running_norm"]
        out["running_norm"] = {"n": rn["n"].numpy().astype(np.int32), "mean": rn["mean"].numpy(),
                               "var": rn["var"].numpy(), "max_update": rn["max_update"].numpy().astype(np.int32)}
    return out
