"""Model FLOPs of MAST (MViTv2 over a log-fbank)."""
from __future__ import annotations

from portbench.reference.encoders.mast import mvit_blocks


def mvit_forward_flops(blocks: list[dict], patch: int, grid0: tuple[int, int]) -> float:
    """Forward FLOPs of one clip through an MViTv2 trunk from its block shapes
    (``reference.encoders.mast.mvit_blocks``): the patch conv, and per block
    the qkv and output projections, the depthwise pooling convs, the rel-pos
    bias products, q k^T and p v, the skip projection and the Mlp."""
    n0 = grid0[0] * grid0[1]
    total = 2.0 * n0 * patch * patch * blocks[0]["dim"]
    for b in blocks:
        n_in = b["hw"][0] * b["hw"][1]
        lq, lk = b["q_hw"][0] * b["q_hw"][1], b["k_hw"][0] * b["k_hw"][1]
        kb = b["k_hw"][0] + b["k_hw"][1]
        d, do = b["dim"], b["dim_out"]
        total += 2.0 * n_in * d * 3 * do  # qkv
        total += 2.0 * 9 * do * (lq + 2 * lk)  # depthwise 3 x 3 pooling of q, k, v
        total += 2.0 * lq * kb * do  # rel-pos bias
        total += 2.0 * 2 * lq * lk * do  # q k^T, p v
        total += 2.0 * lq * do * do  # proj
        if d != do:
            total += 2.0 * n_in * d * do  # skip projection
        total += 2.0 * 2 * lq * do * 4 * do  # Mlp
    return total


def clip_flops(arch: dict, n_mels: int, n_frames: int) -> float:
    blocks = mvit_blocks(arch, (n_frames, n_mels))
    return mvit_forward_flops(blocks, int(arch["patch"]), blocks[0]["hw"])


def out_dim(arch: dict, n_mels: int, n_frames: int) -> int:
    return mvit_blocks(arch, (n_frames, n_mels))[-1]["dim_out"]
