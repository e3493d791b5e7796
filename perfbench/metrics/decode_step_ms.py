"""Device time of one decode step: the replayed decode chunks of the
window, each timed by CUDA events around its replay, over the steps
they ran, in ms."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    ms = [t for kind, _, t in ctx["calls"] if kind == "decode"]
    if not ms:
        return None
    return sum(ms) / (len(ms) * ctx["mix"]["decode_chunk"])
