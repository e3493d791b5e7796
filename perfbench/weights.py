"""Seeded dense weights in the port's parameter layout, drawn on the
device in the type they are served in, one call a leaf.

Both sides take their weights from here: the program gets them at set-up,
and the reference draws them again from the seed once the program is
gone (``reference/`` never reads the program's tensors).  Every leaf has
a generator of its own, seeded from (seed, leaf index), so each is
reproducible alone.

Scales keep every layer's contribution of order one, so that the logits
depend on all layers: the token embedding is N(0, 1/D) (the model scales
it by sqrt(D)), the head and each projection N(0, 1/fan_in); the norm
weights ``w`` of the model's ``1 + w`` start at zero, as the program's own
initialisation has them (a bf16 weight near 0.1 would lose AdamW's
updates of 3e-4 to rounding, which no f32 reference follows).
"""

from __future__ import annotations

import math

#: leaf order: the index in this tuple seeds the leaf's generator
LEAVES = ("embedding", "final_norm", "lm_head", "ln1", "ln2", "attn.wq",
          "attn.wk", "attn.wv", "attn.wo", "mlp.wi", "mlp.wo")


def leaf_shapes(cfg: dict) -> dict:
    """{leaf: (shape, std)} for a GQA decoder with a plain (non-gated)
    MLP, stacked on [L] as the port stacks its layers."""
    D, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab"]
    H, KV, hd, F = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], \
        cfg["d_ff"]
    return {
        "embedding": ((V, D), 1.0 / math.sqrt(D)),
        "final_norm": ((D,), 0.0),
        "lm_head": ((D, V), 1.0 / math.sqrt(D)),
        "ln1": ((L, D), 0.0),
        "ln2": ((L, D), 0.0),
        "attn.wq": ((L, D, H * hd), 1.0 / math.sqrt(D)),
        "attn.wk": ((L, D, KV * hd), 1.0 / math.sqrt(D)),
        "attn.wv": ((L, D, KV * hd), 1.0 / math.sqrt(D)),
        "attn.wo": ((L, H * hd, D), 1.0 / math.sqrt(H * hd)),
        "mlp.wi": ((L, D, F), 1.0 / math.sqrt(D)),
        "mlp.wo": ((L, F, D), 1.0 / math.sqrt(F)),
    }


def leaf_seed(seed: int, leaf: str) -> int:
    return (int(seed) * 1_000_003 + LEAVES.index(leaf) * 7919) % (2 ** 63)


def draw_leaf(torch, cfg: dict, seed: int, leaf: str, device, dtype):
    """One leaf, drawn in one call on ``device`` in ``dtype``."""
    shape, std = leaf_shapes(cfg)[leaf]
    if std == 0.0:
        return torch.zeros(shape, device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, leaf))
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return t.mul_(std)


def dense_params(torch, cfg: dict, seed: int, device, dtype) -> dict:
    """The whole model as nested dicts in the port's layout."""
    flat = {k: draw_leaf(torch, cfg, seed, k, device, dtype) for k in LEAVES}
    return {"embedding": flat["embedding"], "final_norm": flat["final_norm"],
            "lm_head": flat["lm_head"],
            "layers": {"ln1": flat["ln1"], "ln2": flat["ln2"],
                       "attn": {k: flat[f"attn.{k}"]
                                for k in ("wq", "wk", "wv", "wo")},
                       "mlp": {k: flat[f"mlp.{k}"] for k in ("wi", "wo")}}}
