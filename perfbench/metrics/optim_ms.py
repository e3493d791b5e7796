"""Device time a training step spends in the optimizer and the masks:
the kernels that the kernels/optim*.json lists name (AdamW's multi-tensor
functors, the gradient norm, the pattern recompute's top-k), in the
traced window, over its steps, in ms."""

from perfbench import bench, profiling


def read(ctx):
    prof = ctx.get("profile")
    if ctx["kind"] != "train" or not prof or not prof["steps"]:
        return None
    spent = profiling.device_time_s(prof["events"],
                                    bench.kernel_names("optim"))
    return 1e3 * spent / prof["steps"] if spent > 0 else None
