"""Median wall time of one admission (the engine's ``prefill`` span:
the captured prefill program and its host read of the logits) among
those that started in the window, in ms."""

import statistics


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    w0, w1 = ctx["window"]
    durs = [b - a for name, a, b, _ in ctx["spans"]
            if name == "prefill" and w0 <= a < w1]
    return 1e3 * statistics.median(durs) if durs else None
