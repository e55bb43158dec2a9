"""The attention calls' least time (counts.attention_bound of each call's
shapes) over their device time in the traced window, in %.

``WRAPS`` names the port's entry functions of the layer, each with the
least time of one call from its arguments; the traced window's spans wrap
them (``harness/trace.py:Spans``)."""
from portbench import counts
from portbench.metrics import roofline

LAYER = "attn"


def _bound(kind: str):
    def bound(qs, k, v, bias, *rest, **kw):
        return counts.attention_bound(kind, qs.shape[0], qs.shape[1], k.shape[1], qs.shape[2],
                                      0 if bias is None else bias.shape[-1], qs.element_size())
    return bound


WRAPS = [("audiossl_tpu_torch.ops.attention", "rel_attention_fwd", _bound("fwd")),
         ("audiossl_tpu_torch.ops.attention", "rel_attention_bwd_dq", _bound("dq")),
         ("audiossl_tpu_torch.ops.attention", "rel_attention_bwd_dkv", _bound("dkv"))]


def read(ctx: dict) -> float | None:
    return roofline.share(ctx, LAYER)
