"""The training runner: masked AdamW under gradual magnitude pruning
through the port's trainer (``launch/train.py:make_multi_step``, the step
captured once as a CUDA graph and replayed, the pattern recomputes eager
between replays), timed by the host's clock over whole chunks.

Set-up draws the weights from the seed, wraps the schedule's targets in
``FixedMaskTensor`` leaves, builds the AdamW state and the trainer, and
drives that same trainer through its first three steps with the window's
own call and feed (step ``step0``, where the schedule recomputes the
masks, then two more).  It keeps the three losses, each leaf's first
gradient as the optimizer got it (its first moment after one step over
1 - b1) and each leaf's change over the three steps.  The window then
runs chunks of ``chunk`` steps until ``seconds`` have passed.

Correctness: once the window is over and the program is freed, the
reference follows the same three steps in f32 from the seed, and the
worst relative gaps of loss, gradient norm and change norm are held to
the cell's limits.
"""

from __future__ import annotations

import gc
import statistics
import time

from perfbench import profiling, weights
from perfbench.reference import train_ref
from perfbench.traffic import lm_batches

#: the leaves in the program's tree, by the names the reference uses
PATHS = {"embedding": ("embedding",), "final_norm": ("final_norm",),
         "lm_head": ("lm_head",), "ln1": ("layers", "ln1"),
         "ln2": ("layers", "ln2"), "attn.wq": ("layers", "attn", "wq"),
         "attn.wk": ("layers", "attn", "wk"),
         "attn.wv": ("layers", "attn", "wv"),
         "attn.wo": ("layers", "attn", "wo"),
         "mlp.wi": ("layers", "mlp", "wi"), "mlp.wo": ("layers", "mlp", "wo")}


def leaf(tree, name: str):
    for k in PATHS[name]:
        tree = tree[k]
    return getattr(tree, "val", tree)


def gap(p: float, r: float, scale: float) -> float:
    return abs(p - r) / max(abs(r), scale, 1e-30)


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers: the worst step's loss gap; the worst leaf's gap
    of first-gradient norms, against the larger of the leaf's reference
    norm and the median leaf's; the same for the change norms over the
    leaves whose reference gradient is above a thousandth of the median
    leaf's (a leaf with no gradient moves by round-off alone)."""
    loss = max(gap(p, r, 0.0) for p, r in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad = max(gap(prog["grad_norms"][k], g_ref[k], g_med) for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    c_ref = ref["change_norms"]
    c_med = statistics.median(c_ref[k] for k in moved)
    change = max(gap(prog["change_norms"][k], c_ref[k], c_med)
                 for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "left_out": sorted(set(g_ref) - set(moved))}


def run(torch, job: dict) -> dict:
    conf, mix = job["config"], job["traffic"]
    cfg, tcfg = conf["model"], conf["training"]
    dev, seed, seconds = job["device"], job["seed"], job["seconds"]
    from repro_torch.launch.train import build_sparse_params, \
        make_multi_step
    from repro_torch.models.common import ModelConfig
    from repro_torch.optim import AdamWConfig, GMPSchedule, adamw_init

    mcfg = ModelConfig(**cfg)
    g = tcfg["gmp"]
    gmp = GMPSchedule(mode=g["mode"], target_sparsity=g["target_sparsity"],
                      begin_step=g["begin_step"], end_step=g["end_step"],
                      recompute_every=g["recompute_every"],
                      num_layers=cfg["n_layers"])
    params = weights.dense_params(torch, cfg, seed, dev,
                                  getattr(torch, cfg["dtype"]))
    params = build_sparse_params(params, gmp.sparsity_at(0),
                                 targets=tuple(tcfg["mask_globs"]))
    opt = AdamWConfig(**tcfg["adamw"])
    state = adamw_init(params)
    multi = make_multi_step(mcfg, opt, gmp, mix["chunk"])
    step0, stop, chunk = tcfg["step0"], 10 ** 9, mix["chunk"]
    feed = lm_batches.batches(torch, mix, seed, cfg["vocab"], step0,
                              mix["feed_steps"], dev)

    def batches(s: int, n: int) -> dict:
        """Steps s .. s + n - 1 of the feed; past its end the window
        reuses earlier rows (only the first steps are compared)."""
        j = s - step0
        if j + n > mix["feed_steps"]:
            j %= mix["feed_steps"] - n + 1
        return {k: v[j:j + n] for k, v in feed.items()}

    def sync_losses(m) -> list:
        return m["loss"].float().cpu().tolist()

    p0 = {k: leaf(params, k).detach().clone() for k in PATHS}
    params, state, m = multi(params, state, batches(step0, 1), step0, stop)
    losses = sync_losses(m)
    first = {k: float(leaf(state["mu"], k).float().norm()) / (1 - opt.b1)
             for k in PATHS}
    params, state, m = multi(params, state, batches(step0 + 1, 2),
                             step0 + 1, stop)
    losses += sync_losses(m)
    change = {k: float((leaf(params, k).float() - p0[k].float()).norm())
              for k in PATHS}
    del p0
    prog = {"losses": losses, "grad_norms": first, "change_norms": change}
    if dev != "cpu":
        # the reserved memory is then what training holds, the captured
        # step's private pool with it
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - job["t_start"]

    trace = job["trace"] and dev != "cpu"
    marks = profiling.HostMarks()
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()    # the window's peak
    step, done, nonfinite = step0 + 3, 0, 0
    tw0 = time.perf_counter()
    while time.perf_counter() - tw0 < seconds:
        params, state, m = multi(params, state, batches(step, chunk), step,
                                 stop)
        got = sync_losses(m)               # the chunk's one host sync
        nonfinite += sum(1 for x in got if x != x or abs(x) == float("inf"))
        step += chunk
        done += chunk
    window = time.perf_counter() - tw0

    prof = None
    if trace:
        n0 = step

        def segment():
            nonlocal params, state, step
            tp = time.perf_counter()
            while time.perf_counter() - tp < mix.get("profile_s", 3):
                with marks.mark("trainer call: batch copied in, pattern "
                                "recompute, replays launched"):
                    params, state, m2 = multi(params, state,
                                              batches(step, chunk), step,
                                              stop)
                with marks.mark("host sync on the chunk's losses"):
                    sync_losses(m2)
                step += chunk

        prof = profiling.profile(torch, segment, marks)
        prof["steps"] = step - n0
    if dev != "cpu":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_reserved() if dev != "cpu" else 0
    del params, state, multi, feed
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    fb = lm_batches.batches(torch, mix, seed, cfg["vocab"], step0, 3, dev)
    ref_batches = [{k: v[i] for k, v in fb.items()} for i in range(3)]
    ref = train_ref.run(cfg, tcfg, seed, ref_batches, dev)
    gaps = compare(prog, ref)
    checks = {}
    for k in ("loss_gap", "grad_gap", "change_gap"):
        lim = job["limits"].get(k)
        if lim is not None:
            checks[k] = {"value": gaps[k], "limit": lim,
                         "ok": gaps[k] <= lim}
    checks["nonfinite_losses"] = {"value": nonfinite, "limit": 0,
                                  "ok": nonfinite == 0}
    tokens = done * mix["batch"] * mix["seq"]
    return {
        "e2e": {"train_tok_s": tokens / window, "setup_s": setup_s},
        "checks": checks, "attempted": done, "failed": nonfinite,
        "peak": peak, "profile": prof, "gaps": gaps, "program": prog,
        "reference": ref, "reference_s": time.perf_counter() - t_ref,
        "ctx": {"kind": "train", "cfg": cfg, "mix": mix, "window_s": window,
                "steps": done, "profile": prof},
    }
