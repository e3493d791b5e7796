"""The n:m:g projections' share of their roofline in the traced window:
the least time of the work the window's decode steps and admissions
need of them (perfbench/counts/work.py), over the device time of the
kernels that the kernels/nmg*.json lists name, in percent."""

from perfbench import bench, profiling
from perfbench.counts import work


def read(ctx):
    prof = ctx.get("profile")
    if ctx["kind"] != "serve" or not prof or not ctx["sparsity"]:
        return None
    cfg, sp, mix = ctx["cfg"], ctx["sparsity"], ctx["mix"]
    spent = profiling.device_time_s(prof["events"], bench.kernel_names("nmg"))
    if spent <= 0:
        return None
    need = prof["decode_steps"] * work.nmg_call_s(cfg, sp, mix["slots"])
    need += sum(work.nmg_call_s(cfg, sp, S) for S in prof["admissions"])
    return 100.0 * need / spent
