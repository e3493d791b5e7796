"""The serving runner: one cell of traffic through the port's
``ServeEngine`` (slot KV cache, CUDA-graph decode chunks, a captured
admission per prompt length), timed from the client's side.

Set-up draws the dense weights from the seed, converts them to the
configuration's n:m:g format, builds the engine, warms every prompt
length the traffic uses and submits the traffic; a backlog cell then
fills every slot.  The window runs ``engine.step()`` for ``seconds``,
counting the tokens each step returns (the step that crosses the end
with the share of its time inside the window).  A cell with
arrivals then keeps serving, up to ``drain_s``, until every request due
in the window has finished, so that late answers count as late.  With
``trace`` the window also records the engine's spans and each program
run's device time (CUDA events around the replays), and a profiler
session over ``profile_s`` more seconds of the same traffic follows.

Correctness: once the window is over and the program is freed, the
reference runs over a seeded sample of finished requests (the longest
among them), and the mean gap by which a served token's logit lies
below the reference's best is held to the cell's limit
(``reference/serve_check.py``).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import time

import numpy as np

from perfbench import profiling, weights
from perfbench.reference import serve_check


def pct(xs, q: float) -> float:
    a = np.asarray(xs, np.float64)
    return float(np.percentile(a, q)) if a.size else float("nan")


@contextlib.contextmanager
def timed_programs(torch, calls: list, marks: profiling.HostMarks):
    """Every decode and admission program run records CUDA events around
    its replay (device time) and a host mark; the classes are put back
    on exit."""
    from repro_torch.serve import graphs

    saved = {}

    def wrap(cls, kind):
        orig = saved[cls] = cls.run

        def run(self, *a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            with marks.mark(f"{kind}: inputs copied in, graph launched"):
                out = orig(self, *a, **k)
            e1.record()
            calls.append((kind, getattr(self, "S", 0), e0, e1))
            return out
        cls.run = run

    wrap(graphs.DecodeGraph, "decode")
    wrap(graphs.PrefillGraph, "admission")
    try:
        yield
    finally:
        for cls, orig in saved.items():
            cls.run = orig


def sample_for_check(outputs: list, seed: int, check: dict) -> list:
    """The longest finished request, then others in a seeded order, until
    ``check["tokens"]`` served tokens or ``check["max_requests"]``."""
    done = sorted((o for o in outputs if len(o.tokens) > 0),
                  key=lambda o: o.uid)
    if not done:
        return []
    longest = max(done, key=lambda o: (len(o.tokens), -o.uid))
    rest = [o for o in done if o is not longest]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 17]))
    picked, total = [longest], len(longest.tokens)
    for i in rng.permutation(len(rest)):
        if total >= check["tokens"] or len(picked) >= check["max_requests"]:
            break
        picked.append(rest[i])
        total += len(rest[i].tokens)
    return picked


def _records(outputs: list, slots: list) -> list:
    """Every request the engine has touched: (prompt length, admitted
    time, token times), finished or in flight."""
    rec = [(o.prompt_len, o.admitted_time, list(o.token_times))
           for o in outputs if o.token_times]
    rec += [(int(s.req.prompt.size), s.admitted_time, list(s.token_times))
            for s in slots if s is not None]
    return rec


def run(torch, job: dict) -> dict:
    conf, mix = job["config"], job["traffic"]
    cfg, sp = conf["model"], conf.get("sparsity")
    dev, seed, seconds = job["device"], job["seed"], job["seconds"]
    from repro_torch.models.common import ModelConfig
    from repro_torch.obs import trace as obs
    from repro_torch.serve import Request, ServeEngine, \
        sparsify_for_serving, warmup_engine

    mcfg = ModelConfig(**cfg)
    params = weights.dense_params(torch, cfg, seed, dev,
                                  getattr(torch, cfg["dtype"]))
    served = (sparsify_for_serving(params, sp["n"], sp["m"], sp["g"],
                                   gr=sp["gr"], attn=sp["attn"])
              if sp else params)
    del params
    eng = ServeEngine(served, mcfg, max_slots=mix["slots"],
                      max_seq_len=mix["context"],
                      decode_chunk=mix["decode_chunk"], device=dev)
    gen = importlib.import_module(f"perfbench.traffic.{mix['generator']}")
    arrivals = mix["arrivals"] != "backlog"
    extra = mix.get("drain_s", 0) + mix.get("profile_s", 0) + 5
    reqs = gen.generate(mix, seed, cfg["vocab"],
                        until_s=seconds + extra if arrivals else None,
                        count=None if arrivals else mix["backlog"])
    requests = [Request(uid=r["uid"], prompt=r["prompt"],
                        max_new_tokens=r["max_new"], arrival_time=r["due_s"])
                for r in reqs]
    prompts = {r["uid"]: r["prompt"] for r in reqs}
    warmup_engine(eng, requests)
    for r in requests:
        eng.submit(r)
    if not arrivals:
        eng.step()                      # every slot busy before the window
    if dev != "cpu":
        # what set-up freed goes back, so that the reserved memory is what
        # serving holds: the graphs' private pools count there and not
        # among the allocated bytes
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - job["t_start"]

    trace = job["trace"] and dev != "cpu"
    calls: list = []
    marks = profiling.HostMarks()
    stack = contextlib.ExitStack()
    obs_epoch = None
    if trace:
        obs.enable(capacity=1 << 20)
        obs_epoch = time.perf_counter()    # the recorder's time origin
        stack.enter_context(timed_programs(torch, calls, marks))
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()    # the window's peak
    produced, steps = 0.0, 0
    tw0 = t_prev = time.perf_counter()
    while True:
        got = eng.step()
        steps += 1
        now = time.perf_counter()
        if now - tw0 >= seconds:
            # the step that crosses the window's end counts with the
            # share of its time that lies inside the window: a step of
            # many admissions lasts seconds, and whether it fell in whole
            # or not at all moved the rate by 2%
            produced += got * (tw0 + seconds - t_prev) / (now - t_prev)
            break
        produced += got
        t_prev = now
        if not eng.num_active:
            time.sleep(0.0005)
    tw1 = now
    window_calls = calls[:]
    t0 = eng._t0                        # the engine's clock origin
    w0, w1 = tw0 - t0, tw1 - t0         # the window in engine time
    due = [r for r in requests if arrivals and r.arrival_time < w1]
    due_ids = {r.uid for r in due}

    def finished_due():
        return sum(1 for o in eng._outputs if o.uid in due_ids)

    t_drain = time.perf_counter()
    while arrivals and finished_due() < len(due) and \
            time.perf_counter() - t_drain < mix["drain_s"]:
        eng.step()
        if not eng.num_active:
            time.sleep(0.0005)
    drain_end = time.perf_counter() - t0

    prof = None
    if trace:
        marks.marks.clear()
        steps_before = eng.stats["decode_steps"]
        n_calls = len(calls)

        def segment():
            tp = time.perf_counter()
            while time.perf_counter() - tp < mix.get("profile_s", 5):
                with marks.mark("engine step: scheduling, host syncs, "
                                "token bookkeeping"):
                    eng.step()
                if not eng.num_active:
                    time.sleep(0.0005)

        prof = profiling.profile(torch, segment, marks)
        prof["decode_steps"] = eng.stats["decode_steps"] - steps_before
        prof["admissions"] = [S for kind, S, _, _ in calls[n_calls:]
                              if kind == "admission"]
        stack.close()
        obs.disable()
    if dev != "cpu":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_reserved() if dev != "cpu" else 0

    outputs = list(eng._outputs)
    records = _records(outputs, eng._slots)
    # the engine's spans, in engine seconds
    spans = [(name, obs_epoch + ts / 1e6 - t0,
              obs_epoch + (ts + dur) / 1e6 - t0, attrs or {})
             for ph, name, _, ts, dur, attrs in obs.records()
             if ph == "X"] if trace else []
    call_ms = [(kind, S, e0.elapsed_time(e1)) for kind, S, e0, e1
               in window_calls]
    by_uid = {o.uid: o for o in outputs}
    ttft, tpot, qwait, failed = [], [], [], 0
    for r in due:
        o = by_uid.get(r.uid)
        if o is None or not o.tokens:
            failed += 1
            ttft.append(drain_end - r.arrival_time)
            continue
        ttft.append(o.token_times[0] - r.arrival_time)
        qwait.append(o.admitted_time - r.arrival_time)
        if len(o.tokens) > 1:
            tpot.append((o.finish_time - o.token_times[0])
                        / (len(o.tokens) - 1))
    if not arrivals:
        failed = sum(1 for o in outputs if not o.tokens)
    attempted = len(due) if arrivals else sum(
        1 for _, adm, times in records if times and times[-1] >= w0)

    admitted = {o.uid: o.admitted_time for o in outputs if o.tokens}
    admitted.update({s.req.uid: s.admitted_time for s in eng._slots
                     if s is not None})
    queueing = [(r.arrival_time, admitted.get(r.uid, float("inf")))
                for r in due]

    sample = sample_for_check(outputs, seed, mix["check"]) \
        if job.get("check", True) else []
    seqs = [(prompts[o.uid], list(o.tokens)) for o in sample]
    # the program's state goes before the reference runs
    del eng, served
    if trace:
        obs.reset()
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    gaps = serve_check.gaps(cfg, sp, seed, seqs, dev,
                            control=job.get("control", False)) \
        if job.get("check", True) else None
    mean = gaps["program"]["mean"] if gaps else 0.0
    limit = job["limits"]["served_gap_mean"]
    checks = {"served_gap_mean": {"value": mean, "limit": limit,
                                  "ok": mean <= limit},
              "requests_unserved": {"value": failed, "limit": 0,
                                    "ok": failed == 0}}
    window = tw1 - tw0
    e2e = {"out_tok_s": produced / seconds, "setup_s": setup_s}
    notes = [f"served tokens compared {gaps['tokens']}, widest gap "
             f"{gaps['program']['max']!r} (not compared)"] if gaps else []
    if arrivals:
        e2e["ttft_p90_ms"] = pct(ttft, 90) * 1e3
        e2e["tpot_p90_ms"] = pct(tpot, 90) * 1e3
        notes.append(
            f"requests due {len(due)}: ttft ms p50/p90/p95/p99 " + "/".join(
                f"{pct(ttft, q) * 1e3:.1f}" for q in (50, 90, 95, 99))
            + ", tpot ms p50/p90/p95 " + "/".join(
                f"{pct(tpot, q) * 1e3:.2f}" for q in (50, 90, 95)))
    return {
        "e2e": e2e, "checks": checks, "attempted": attempted,
        "failed": failed, "peak": peak, "profile": prof,
        "reference_s": time.perf_counter() - t_ref,
        "gaps": gaps, "queueing": queueing, "notes": notes,
        "ctx": {"kind": "serve", "cfg": cfg, "sparsity": sp, "mix": mix,
                "window": (w0, w1), "window_s": window, "spans": spans,
                "calls": call_ms, "records": records, "queue_wait_s": qwait,
                "profile": prof},
    }
