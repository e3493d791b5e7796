"""The whole serving step's share of the chip's bf16 peak over the
window: every prompt admitted in the window and every token decoded in
it, each through the weights at their nonzeros (the n:m:g projections at
n/m, the head dense) plus attention over the rows it reads, over
(window x peak), in percent."""

from perfbench.counts import work


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    cfg, sp = ctx["cfg"], ctx["sparsity"]
    w0, w1 = ctx["window"]
    per_token = work.token_flops(cfg, sp)
    flops = 0.0
    for S, admitted, times in ctx["records"]:
        if times and w0 <= times[0] <= w1:          # admitted in the window
            flops += S * per_token + work.prompt_attn_flops(cfg, S)
        for k, t in enumerate(times[1:], start=2):  # decoded tokens
            if w0 <= t <= w1:
                flops += per_token + work.attn_flops(cfg, S + k - 1)
    return 100.0 * flops / ((w1 - w0) * work.PEAKS["bf16_flop_s"])
