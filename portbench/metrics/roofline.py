"""A layer's roofline share: the sum of its calls' least times over the
device time of the kernels launched inside its spans."""


def share(ctx: dict, layer: str) -> float | None:
    if "trace" not in ctx or not ctx["spans"].calls.get(layer):
        return None
    if ctx["trace"]["unplaced_device_events"]:
        return None  # kernels the trace cannot tie to a call: the layer's time is not known
    device_s = ctx["trace"]["span_s"].get(layer, 0.0)
    return 100.0 * ctx["spans"].bound[layer] / device_s if device_s > 0 else None
