"""A LayerNorm over the last axis, at the encoder's epsilon."""
from __future__ import annotations

from portbench.reference.precision import Precision


def output(x, p: dict, prec: Precision, encoder):
    return prec.layer_norm(x.float(), p["weight"], p["bias"], encoder.LN_EPS)
