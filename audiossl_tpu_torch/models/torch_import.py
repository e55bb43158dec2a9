"""Import the reference's torch checkpoints into the port (port of
``audiossl_tpu.models.torch_import``).

A user switching from the reference holds its weights in one of three forms:
Lightning upstream checkpoints whose ``encoder_q`` wraps AudioNTT2020Task6
(src/utils/utils.py:199-207 loads ``encoder_q.state_dict()``), raw AudioNTT
state_dicts (src/encoder/audiontt.py:37-104), DeiT / AST transformer
checkpoints (extras/mast_new/mast/models/ast_models_pre_train.py:100-125:
RGB patch kernels summed to one channel, a square position grid), and
SS-MAST / MViTv2 checkpoints in timm's stage nesting. The port's checkpoints
hold every encoder in the reference's own layout (``encoder/<step>.pt``,
models/convert.py), so importing is selecting and normalising:

* the sub-dict below the (query encoder's) prefix: Lightning and MoCo
  nestings such as ``encoder_q.encoder.`` or ``encoder_q.ast_model.v.``;
* AST: the RGB fold (a 3-channel patch kernel summed to 1), the grid of the
  positional embedding (square unless given), and only the trunk's keys
  (no head);
* MAST: timm's ``stages.{s}.blocks.{b}`` renumbered into the flat
  ``blocks.{i}`` in order, timm's ``shortcut_proj_attn`` /
  ``shortcut_proj_mlp`` as ``proj``, and the final ``norm`` left out (the
  reference MAST forward skips it, ast_work.py:229).

The CLI writes the result as an encoder-only checkpoint (``train.checkpoint.
save_encoder_only``) with a ``config.yaml`` naming the encoder and, where
it is known, the input it was trained at, which ``train_downstream
--checkpoint`` reads (the cross-shape surgery adapts another input shape):

  python -m audiossl_tpu_torch.models.torch_import --checkpoint ref.ckpt \\
      --arch audiontt|ast|mast --out runs/imported [--src_fdim F --src_tdim T] \\
      [--input_fdim M --input_tdim N]
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

AST_KEYS = re.compile(r"^(patch_embed\.proj\.(weight|bias)|cls_token|dist_token|pos_embed|norm\.(weight|bias)|"
                      r"blocks\.\d+\.(norm1|norm2|attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2)\.(weight|bias))$")
MVIT_KEYS = re.compile(r"^(patch_embed\.proj\.(weight|bias)|blocks\.\d+\.(norm1|norm2|attn\.qkv|attn\.proj|"
                       r"attn\.pool_[qkv]|attn\.norm_[qkv]|mlp\.fc1|mlp\.fc2|proj)\.(weight|bias)|"
                       r"blocks\.\d+\.attn\.rel_pos_[hw])$")


def _t(v: Any) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v.detach().cpu()
    return t.float().contiguous() if t.is_floating_point() else t.contiguous()


def load_torch_checkpoint(path: str) -> dict[str, Any]:
    """``torch.load`` a .pth / .ckpt, unwrapping Lightning's ``{"state_dict": ...}``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return dict(ckpt)


def strip_prefix(sd: Mapping[str, Any], anchor: str) -> dict[str, Any]:
    """The sub-dict below the prefix of the key ending in ``anchor`` (e.g.
    "features_1.0.weight" finds the AudioNTT in
    "encoder_q.encoder.features_1.0.weight"); where several prefixes carry it
    (a MoCo checkpoint's encoder_q and encoder_k) the query encoder's, as the
    reference's loader takes."""
    hits = {k[: -len(anchor)] for k in sd if k.endswith(anchor)}
    if not hits:
        raise KeyError(f"no key ending with {anchor!r} in state_dict")
    if len(hits) > 1:
        q = [p for p in sorted(hits) if "encoder_k" not in p]
        hits = {q[0]} if q else {sorted(hits)[0]}
    prefix = hits.pop()
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def audiontt_from_torch(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Reference AudioNTT2020Task6 weights at any prefix depth -> the
    reference layout ``models.audiontt.AudioNTT2020Task6`` loads (features_{1,2,3}
    conv / BN blocks with their running statistics, fc.0 and fc.3)."""
    sd = {k: _t(v) for k, v in strip_prefix(state_dict, "features_1.0.weight").items()}
    keep = re.compile(r"^(features_[123]\.[01]\.|fc\.[03]\.)")
    out = {k: v for k, v in sd.items() if keep.match(k)}
    for i in (1, 2, 3):  # a state_dict saved without the counters (an older torch) loads with zeros
        out.setdefault(f"features_{i}.1.num_batches_tracked", torch.zeros((), dtype=torch.long))
    return out


def ast_from_torch(state_dict: Mapping[str, Any],
                   src_grid_ft: tuple[int, int] | None = None) -> tuple[dict[str, torch.Tensor], tuple[int, int]]:
    """timm DeiT / reference AST weights -> (the reference-layout AST trunk,
    its (freq, time) patch grid). A multi-channel patch kernel folds to one
    channel by summation (mast.py:103-105); ``src_grid_ft`` defaults to a
    square grid (raw DeiT) and must account for the positional embedding's
    tokens past the cls and dist tokens."""
    sd = {k: _t(v) for k, v in strip_prefix(state_dict, "patch_embed.proj.weight").items() if AST_KEYS.match(k)}
    proj = sd["patch_embed.proj.weight"]
    if proj.shape[1] > 1:
        sd["patch_embed.proj.weight"] = proj.sum(dim=1, keepdim=True)
    n = sd["pos_embed"].shape[1] - 2
    if src_grid_ft is None:
        side = int(round(n**0.5))
        if side * side != n:
            raise ValueError(f"pos_embed grid of {n} tokens is not square; pass src_grid_ft")
        src_grid_ft = (side, side)
    if src_grid_ft[0] * src_grid_ft[1] != n:
        raise ValueError(f"src_grid_ft {src_grid_ft} != {n} grid tokens")
    if "blocks.0.norm1.weight" not in sd:
        raise KeyError("no transformer blocks found (expected blocks.0.norm1.weight)")
    return sd, tuple(src_grid_ft)


def _flatten_stage_blocks(sd: dict[str, Any]) -> dict[str, Any]:
    """timm's ``stages.{s}.blocks.{b}.*`` as the flat ``blocks.{i}.*``,
    numbered across the stages in order (the reference iterates
    ``self.v.stages``, ast_work.py:224-227)."""
    pat = re.compile(r"^stages\.(\d+)\.blocks\.(\d+)\.(.+)$")
    hits = sorted({(int(m.group(1)), int(m.group(2))) for k in sd if (m := pat.match(k))})
    if not hits:
        return sd
    index = {sb: i for i, sb in enumerate(hits)}
    out = {}
    for k, v in sd.items():
        m = pat.match(k)
        out[f"blocks.{index[(int(m.group(1)), int(m.group(2)))]}.{m.group(3)}" if m else k] = v
    return out


def mast_from_torch(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Reference SS-MAST / MViTv2 weights (timm's stage nesting or the
    vendored flat blocks, mvit/models/attention.py:325-396) -> the
    reference-layout MAST trunk (freq-major, as ``models.convert.
    mast_from_flax`` writes it), without the final norm."""
    sd = _flatten_stage_blocks({k: _t(v) for k, v in strip_prefix(state_dict, "patch_embed.proj.weight").items()})
    for k in list(sd):
        m = re.match(r"^(blocks\.\d+)\.shortcut_proj_(attn|mlp)\.(weight|bias)$", k)
        if m:
            sd[f"{m.group(1)}.proj.{m.group(3)}"] = sd.pop(k)
    out = {k: v for k, v in sd.items() if MVIT_KEYS.match(k)}
    if "blocks.0.norm1.weight" not in out:
        raise KeyError("no MViT blocks found (expected blocks.0.norm1.weight or stages.*)")
    return out


ARCHS = {"audiontt": "AudioNTT2020Task6", "ast": "AST", "mast": "MAST"}


def main(argv: list[str] | None = None) -> str:
    """Convert a reference torch checkpoint into an encoder-only checkpoint
    of the port under ``--out``; returns ``--out``."""
    import argparse
    import os

    import yaml

    from audiossl_tpu_torch.train.checkpoint import save_encoder_only

    p = argparse.ArgumentParser(description="Import a reference torch checkpoint as an encoder checkpoint")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--arch", choices=sorted(ARCHS), required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--src_fdim", type=int, default=None, help="AST source grid: freq patches")
    p.add_argument("--src_tdim", type=int, default=None, help="AST source grid: time patches")
    p.add_argument("--input_fdim", type=int, default=None, help="mel bins the checkpoint was trained at")
    p.add_argument("--input_tdim", type=int, default=None, help="frames the checkpoint was trained at")
    args = p.parse_args(argv)

    sd = load_torch_checkpoint(args.checkpoint)
    fdim, tdim = args.input_fdim, args.input_tdim
    if args.arch == "audiontt":
        enc = audiontt_from_torch(sd)
    elif args.arch == "mast":
        enc = mast_from_torch(sd)
    else:
        grid = (args.src_fdim, args.src_tdim) if args.src_fdim and args.src_tdim else None
        enc, (f, t) = ast_from_torch(sd, grid)
        # the input a 16 x 16 patch at stride 10 gives that grid from, unless given
        fdim, tdim = fdim or 10 * (f - 1) + 16, tdim or 10 * (t - 1) + 16
    save_encoder_only(args.out, 0, enc)
    inp = {"type": "fbank" if args.arch != "audiontt" else "logmel"}
    if fdim:
        inp["n_mels"] = fdim
    if tdim:
        inp["target_length"] = tdim
    with open(os.path.join(args.out, "config.yaml"), "w") as f_:
        yaml.safe_dump({"pretrain": {"base_encoder": {"type": ARCHS[args.arch]}, "input": inp}}, f_)
    n = sum(v.numel() for v in enc.values() if v.is_floating_point())
    print(f"imported {args.arch} torch checkpoint -> {args.out} ({n:,} params)")
    return args.out


if __name__ == "__main__":
    main()
