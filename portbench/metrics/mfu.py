"""The whole step's (or the served clips') model FLOPs over the seconds of
back-to-back work, as a share of one bf16 peak (counts.PEAK_BF16), in %:
the plain measured window where the cell runs back to back, else the
loop's back-to-back pass of the traced run (an open loop's window is paced
by its arrivals, so its rate is the load's, not the program's)."""
from portbench import counts


def read(ctx: dict) -> float | None:
    w = ctx.get("back_to_back") or ctx["window"]
    if not w.get("flops") or not w.get("seconds"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / counts.PEAK_BF16
