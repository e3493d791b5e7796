"""Operations and bytes that the mathematics of a step needs, from the
shapes alone: what any kernel has to do, not what the program's kernels
happen to move.  A fused or faster kernel leaves these counts as they
are, so a share of the roofline moves only with the time.

Bytes count each input read once and each output written once; FLOPs
count two per multiply-add of a value that is kept.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

#: the projections of a layer: name -> (K, N) from the model sizes
def projections(cfg: dict) -> dict:
    D, H, KV, hd, F = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                       cfg["head_dim"], cfg["d_ff"])
    return {"attn.wq": (D, H * hd), "attn.wk": (D, KV * hd),
            "attn.wv": (D, KV * hd), "attn.wo": (H * hd, D),
            "mlp.wi": (D, F), "mlp.wo": (F, D)}


def sparse_projections(cfg: dict, sp: dict) -> dict:
    """The projections the n:m:g conversion covers."""
    return {k: v for k, v in projections(cfg).items()
            if k.startswith("mlp.") or sp.get("attn", False)}


def nmg_work(K: int, N: int, sp: dict, rows: int, elem: int = 2) -> tuple:
    """(FLOPs, bytes) of y [rows, N] = x [rows, K] @ W for an n:m:g weight
    W [K, N] sparse along K: its kept values, the column index of each
    kept value shared by a group of ``gr`` output rows (int32), the
    activations in and out."""
    n, m, gr = sp["n"], sp["m"], sp["gr"]
    nnz = K * N * n // m
    index = math.ceil(N / gr) * (K * n // m) * 4
    nbytes = nnz * elem + index + rows * K * elem + rows * N * elem
    return 2 * nnz * rows, nbytes


def roofline_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAKS["bf16_flop_s"], nbytes / PEAKS["hbm_byte_s"])


def nmg_call_s(cfg: dict, sp: dict, rows: int) -> float:
    """The least time of one pass of every n:m:g projection of every
    layer over ``rows`` rows (a decode step: the slots; an admission:
    the prompt)."""
    return cfg["n_layers"] * sum(
        roofline_s(*nmg_work(K, N, sp, rows))
        for K, N in sparse_projections(cfg, sp).values())


def token_flops(cfg: dict, sp: dict | None) -> float:
    """FLOPs of one token through the weights at their nonzeros (n:m:g
    projections at n/m, the rest and the head dense)."""
    flops = 0
    sparse = sparse_projections(cfg, sp) if sp else {}
    for name, (K, N) in projections(cfg).items():
        dens = sp["n"] / sp["m"] if name in sparse else 1.0
        flops += 2 * K * N * dens
    return cfg["n_layers"] * flops + 2 * cfg["d_model"] * cfg["vocab"]


def attn_flops(cfg: dict, keys: int) -> float:
    """FLOPs of one query over ``keys`` cached keys in every layer:
    scores and the weighted sum of values."""
    return 4 * cfg["n_layers"] * cfg["n_heads"] * cfg["head_dim"] * keys


def prompt_attn_flops(cfg: dict, S: int) -> float:
    """Causal attention over a prompt of S tokens: query i sees i + 1
    keys."""
    return attn_flops(cfg, S * (S + 1) // 2)


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Forward and backward (three products a weight) of a training step
    at dense width (masked training computes dense), and causal
    attention likewise."""
    dense = sum(K * N for K, N in projections(cfg).values()) * cfg["n_layers"] \
        + cfg["d_model"] * cfg["vocab"]
    return 3 * (2 * dense * batch * seq
                + batch * prompt_attn_flops(cfg, seq))
