"""Share of the window the scheduler spent in admissions: the engine's
``prefill`` spans (an admission's program and its host read of the
logits) inside the window, over the window, in percent."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["spans"]:
        return None
    w0, w1 = ctx["window"]
    busy = sum(min(b, w1) - max(a, w0) for name, a, b, _ in ctx["spans"]
               if name == "prefill" and b > w0 and a < w1)
    return 100.0 * busy / (w1 - w0)
