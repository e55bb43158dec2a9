"""Model FLOPs of AST (a ViT over patch tokens)."""
from __future__ import annotations


def vit_forward_flops(n_tokens: int, n_patches: int, dim: int, depth: int, patch: int, mlp_ratio: float = 4.0) -> float:
    """Forward FLOPs of one clip through a ViT: the patch conv, and per
    block qkv, q k^T, p v, proj and the Mlp."""
    per_block = 2.0 * n_tokens * dim * (3 * dim + dim + 2 * mlp_ratio * dim) + 2.0 * 2 * n_tokens * n_tokens * dim
    return 2.0 * n_patches * patch * patch * dim + depth * per_block


def clip_flops(arch: dict, n_mels: int, n_frames: int) -> float:
    """Patches at the arch's stride on both axes, plus the cls and dist tokens."""
    p, s = int(arch["patch"]), int(arch["stride"])
    patches = ((n_frames - p) // s + 1) * ((n_mels - p) // s + 1)
    return vit_forward_flops(patches + 2, patches, int(arch["embed_dim"]), int(arch["depth"]), p,
                             float(arch.get("mlp_ratio", 4.0)))

