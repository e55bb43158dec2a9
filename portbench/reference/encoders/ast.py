"""AST (Gong et al., arXiv:2104.01778) as a plain function of its weights:
DeiT-B over 16 x 16 patches at stride 10, cls and dist tokens, a learned
position embedding, pre-norm blocks, the final LayerNorm, the mean of the
cls and dist outputs."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.models import linear, softmax_attention, sub
from portbench.reference.precision import F32, Precision

LN_EPS = 1e-6


def forward(x, p: dict, arch: dict, prec: Precision = F32, draws=None):
    """[B, 1, F, T] -> [B, D]: (cls + dist) / 2 after the final norm (no drop path)."""
    x = x.transpose(-1, -2)
    s, heads = arch["stride"], int(arch["num_heads"])
    x = F.conv2d(prec.g(x), prec.g(p["patch_embed.proj.weight"]), p["patch_embed.proj.bias"], (s, s))
    x = x.flatten(2).transpose(1, 2)
    b = x.shape[0]
    x = torch.cat([p["cls_token"].expand(b, -1, -1), p["dist_token"].expand(b, -1, -1), x], 1) + p["pos_embed"]
    n, d = x.shape[1], x.shape[2]
    dh = d // heads
    for i in range(int(arch["depth"])):
        q = sub(p, f"blocks.{i}.")
        h = prec.layer_norm(x, q["norm1.weight"], q["norm1.bias"], LN_EPS)
        qkv = linear(h, q["attn.qkv.weight"], q["attn.qkv.bias"], prec).reshape(b, n, 3, heads, dh)
        qkv = qkv.permute(2, 0, 3, 1, 4).reshape(3, b * heads, n, dh)
        a = softmax_attention(qkv[0], qkv[1], qkv[2], dh ** -0.5, prec).reshape(b, heads, n, dh)
        x = x + linear(a.transpose(1, 2).reshape(b, n, d), q["attn.proj.weight"], q["attn.proj.bias"], prec)
        h = prec.layer_norm(x, q["norm2.weight"], q["norm2.bias"], LN_EPS)
        x = x + linear(F.gelu(linear(h, q["mlp.fc1.weight"], q["mlp.fc1.bias"], prec)), q["mlp.fc2.weight"],
                       q["mlp.fc2.bias"], prec)
    x = prec.layer_norm(x, p["norm.weight"], p["norm.bias"], LN_EPS)
    return (x[:, 0] + x[:, 1]) / 2.0
