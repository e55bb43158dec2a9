"""A transformer block's Mlp: fc2(GELU(fc1(x))). With products narrower
than float32 each product's result and the GELU's are stored in bfloat16,
as a bf16 layer stores them."""
from __future__ import annotations

import torch.nn.functional as F

from portbench.reference.precision import Precision


def output(x, p: dict, prec: Precision, encoder):
    h = prec.out(F.linear(prec.g(x.float()), prec.g(p["fc1.weight"]), prec.out(p["fc1.bias"])))
    h = prec.out(F.gelu(h))
    return prec.out(F.linear(prec.g(h), prec.g(p["fc2.weight"]), prec.out(p["fc2.bias"])))
