"""The mean time from a request's due time to the start of its call, from
the harness's own open-loop generator, in ms."""


def read(ctx: dict) -> float | None:
    return ctx["window"].get("queue_wait_ms")
