"""The serving comparison: the reference's logits over each sampled
request's prompt and served tokens, and how far below the reference's
best each served token lies.

The reference draws the dense weights again from the seed, prunes every
projection by its own copy of the greedy n:m:g conversion and runs the
decoder in f32, a layer at a time over all sampled requests.  With
``control`` it runs the fp8 control beside it on the same inputs and
reads, at each served position, the gap of the token the control puts
first.

The number held to the limit is the mean gap over the served tokens.
The widest gap separates the program from the control by only about
2x, short of the 3x a limit needs (the program's bf16 residual stream
and KV cache carry noise of the same order as fp8 products, and a
widest gap grows with the noise); the mean grows with its square (a flip
is as likely as the noise is large, and its gap as large as the noise),
PERF.md.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import weights
from perfbench.reference import decoder, lowp
from perfbench.reference.nmg_prune import nmg_mask

PROJ = {"wq": "attn.wq", "wk": "attn.wk", "wv": "attn.wv", "wo": "attn.wo",
        "wi": "mlp.wi", "wo2": "mlp.wo"}


def layer_weights(dense: dict, layer: int, sp: dict) -> dict:
    """Layer ``layer``'s weights in f32: each projection pruned as the
    configuration's sparsity says, the norms as drawn."""
    w = {"ln1": dense["ln1"][layer].float(), "ln2": dense["ln2"][layer].float()}
    for k, leaf in PROJ.items():
        t = dense[leaf][layer]
        if sp and (leaf.startswith("mlp") or sp.get("attn", False)):
            t = t * nmg_mask(t, sp["n"], sp["m"], sp["g"], sp["gr"]).to(t.dtype)
        w[k] = t.float()
    return w


def _stats(per_request: list) -> dict:
    """The gaps of every compared token: their mean (the number held to
    the limit) and their largest."""
    if not per_request:
        return {"mean": float("inf"), "max": float("inf")}
    g = torch.cat(per_request)
    return {"mean": float(g.mean()), "max": float(g.max())}


def gaps(cfg: dict, sp: dict | None, seed: int, seqs: list, device, *,
         control: bool = False) -> dict:
    """``seqs``: [(prompt [S] ints, served [N] ints)].  For each served
    token, how far its reference logit lies below the reference's best at
    its position (0 where the reference would have served it too).
    Returns {"program": {"mean", "max"}, "control": the same for the
    tokens the fp8 control puts first, or None; "tokens": served tokens
    compared}."""
    decoder.no_tf32()
    dt = getattr(torch, cfg["dtype"])
    dense = {k: weights.draw_leaf(torch, cfg, seed, k, device, dt)
             for k in weights.LEAVES}
    inputs = []
    for prompt, served in seqs:
        toks = np.concatenate([np.asarray(prompt), np.asarray(served[:-1])])
        inputs.append(torch.as_tensor(toks.astype(np.int64), device=device))
    emb = dense["embedding"].float()
    xs = [decoder.embed(cfg, emb, t) for t in inputs]
    xc = [x.clone() for x in xs] if control else None
    del emb
    with torch.no_grad():
        for layer in range(cfg["n_layers"]):
            w = layer_weights(dense, layer, sp)
            xs = [decoder.layer(cfg, w, x) for x in xs]
            if control:
                xc = [decoder.layer(cfg, w, x, mm=lowp.fp8_mm) for x in xc]
            del w
        fn, head = dense["final_norm"].float(), dense["lm_head"].float()
        prog, low = [], []
        for i, (prompt, served) in enumerate(seqs):
            S = len(prompt)
            ref = decoder.logits(xs[i][S - 1:], fn, head)        # [N, V]
            best = ref.max(dim=-1).values
            tok = torch.as_tensor(np.asarray(served, np.int64), device=device)
            prog.append(best - ref.gather(1, tok[:, None])[:, 0])
            if control:
                pick = decoder.logits(xc[i][S - 1:], fn, head,
                                      mm=lowp.fp8_mm).argmax(dim=-1)
                low.append(best - ref.gather(1, pick[:, None])[:, 0])
    out = {"tokens": sum(len(s) for _, s in seqs), "program": _stats(prog),
           "control": _stats(low) if control else None}
    return out
