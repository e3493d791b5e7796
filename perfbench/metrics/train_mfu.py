"""The whole training step's share of the chip's bf16 peak over the
window: forward and backward of every step at dense width (masked
training computes dense) plus causal attention, over (window x peak),
in percent."""

from perfbench.counts import work


def read(ctx):
    if ctx["kind"] != "train":
        return None
    mix = ctx["mix"]
    flops = ctx["steps"] * work.train_step_flops(ctx["cfg"], mix["batch"],
                                                 mix["seq"])
    return 100.0 * flops / (ctx["window_s"] * work.PEAKS["bf16_flop_s"])
