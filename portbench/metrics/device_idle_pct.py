"""The traced window's share of wall time in which no kernel, copy or fill
ran on the device (the union of their intervals, not the sum), in %."""


def read(ctx: dict) -> float | None:
    if "trace" not in ctx or not ctx["trace_window_s"]:
        return None
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / ctx["trace_window_s"])
