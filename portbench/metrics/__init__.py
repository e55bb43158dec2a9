"""Per-layer metric readers, one module per metric named by the part of its
name before the first dot (``mfu.train`` -> ``mfu.py``). Each has
``read(ctx) -> float | None``: ``ctx["window"]`` is the measured window's
record, and in a traced run ``ctx["trace"]`` the reduced trace,
``ctx["spans"]`` the layers' least times, ``ctx["trace_window_s"]`` the
traced window's length and, for a loop that is not back to back,
``ctx["back_to_back"]`` its unprofiled back-to-back pass. A reader that
finds nothing to read returns None. A reader of a layer's spans declares
``LAYER`` and ``WRAPS``: (module, function, least seconds of a call from
its arguments) for each of the port's entry functions of that layer."""
