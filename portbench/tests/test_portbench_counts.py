"""The counts against values worked by hand at small shapes."""
import math

import pytest

from portbench import counts
from portbench.counts import ast as ast_counts
from portbench.counts import mast as mast_counts
from portbench.reference.encoders import mast as mast_ref


def test_attention_bound_by_operations_and_by_bytes():
    # fwd, bh 2, lq 4, lk 8, d 16, no bias, bf16: bytes 2 * (2*128 + 2*256) = 1536; 2 products of 2*2*4*8*16 FLOP
    assert counts.attention_bound("fwd", 2, 4, 8, 16, 0, 2) == pytest.approx(max(1536 / 3.35e12, 2 * 2048 / 989e12))
    # a long key row: bound by operations; lq 1024, lk 1024, d 64, bh 1: 2 * 2 * 1024 * 1024 * 64 FLOP
    assert counts.attention_bound("fwd", 1, 1024, 1024, 64, 0, 2) == pytest.approx(2 * 2 * 1024 * 1024 * 64 / 989e12)
    # dq with a bias of width 6: bytes 2*(3*64 + 2*128 + 2*24) + 12*4 = 1040
    assert counts.attention_bound("dq", 1, 4, 8, 16, 6, 2) == pytest.approx(max(1040 / 3.35e12, 3 * 2 * 512 / 989e12))
    # dkv: bytes 2*(2*64 + 4*128 + 24) + 48 = 1376; 4 products
    assert counts.attention_bound("dkv", 1, 4, 8, 16, 6, 2) == pytest.approx(max(1376 / 3.35e12, 4 * 2 * 512 / 989e12))


def test_logmel_and_rows_flops():
    # n_fft 8, 2 mels, 3 frames, 5 nonzero mel entries: per frame 8 + 2.5*8*3 + 4*5 + 10 + 4 = 102
    assert counts.logmel_flops(8, 2, 3, 5) == 3 * 102
    # rows 2, width 6, n_fft 8, 2 mels, 5 nonzero: per row 6 + 60 + 15 + 10 + 4 = 95
    assert counts.rows_flops(2, 6, 8, 2, 5) == 2 * 95


def test_frontend_bound_reads_and_writes_once():
    # 1 clip of 16000 samples to 64 x 98 features: bytes 4 * (16000 + 6272)
    t = counts.frontend_bound("fbank", 1, 16000, 64, 98, 300)
    assert t >= 4 * (16000 + 64 * 98) / 3.35e12
    assert t == pytest.approx(max(4 * (16000 + 6272) / 3.35e12, counts.rows_flops(98, 400, 512, 64, 300) / 67e12))


def test_vit_flops_by_hand():
    # 3 tokens (1 patch + 2), dim 4, depth 1, patch 2, mlp ratio 4
    per_block = 2 * 3 * 4 * (12 + 4 + 32) + 2 * 2 * 9 * 4
    assert ast_counts.vit_forward_flops(3, 1, 4, 1, 2) == 2 * 1 * 4 * 4 + per_block


def test_mvit_flops_by_hand():
    # one block over a 4 x 4 grid, dim 8, one head, q pooled at stride 1, kv at stride 2
    arch = dict(embed_dim=8, depth=1, num_heads=1, stage_blocks=[], droppath_rate=0.0, patch=2, stride=2,
                pool_kv_stride_adaptive=[2, 2])
    blocks = mast_ref.mvit_blocks(arch, (8, 8))
    assert blocks[0]["hw"] == (4, 4) and blocks[0]["k_hw"] == (2, 2)
    n, lq, lk, kb, d = 16, 16, 4, 4, 8
    want = (2 * 16 * 4 * 8 + 2 * n * d * 3 * d + 2 * 9 * d * (lq + 2 * lk) + 2 * lq * kb * d + 4 * lq * lk * d
            + 2 * lq * d * d + 4 * lq * d * 4 * d)
    assert mast_counts.mvit_forward_flops(blocks, 2, (4, 4)) == want


def test_mast_b_and_ast_base_shapes():
    import json
    import os

    from portbench.harness import spec

    mast = json.load(open(os.path.join(spec.PKG, "configs", "mast-b.json")))
    blocks = mast_ref.mvit_blocks(mast["arch"], (1024, 128))
    assert blocks[0]["hw"] == (101, 12) and blocks[-1]["dim_out"] == 768 and blocks[-1]["heads"] == 8
    assert [b["dim_out"] for b in blocks].count(768) == 3
    assert math.isclose(ast_counts.vit_forward_flops(1214, 1212, 768, 12, 16) / 1e9, 261.03, rel_tol=1e-3)
    ast = json.load(open(os.path.join(spec.PKG, "configs", "ast-base.json")))
    assert counts.encoder_flops("AST", ast["arch"], 128, 1024) == ast_counts.vit_forward_flops(1214, 1212, 768, 12, 16)
    assert counts.encoder_flops("MAST", mast["arch"], 128, 1024) == mast_counts.clip_flops(mast["arch"], 128, 1024)
