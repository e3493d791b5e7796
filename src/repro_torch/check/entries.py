"""Entry-point builders: the real serving and training programs as
:class:`~repro_torch.check.program.CheckedProgram` lists (port of
``repro/check/entries.py``).

The checker runs the same callables the runtime runs and captures:
``serve/engine.py:serve_programs`` for the engine's decode, chunked
decode and prefill, and ``launch/train.py:make_train_step`` for the step
the graph trainer replays, at the smoke scale by default (the rules judge
the program's structure, which does not depend on scale).  Check configs
pin ``dtype=float32``, as the reference's do: f32 is then the widest
float the model reaches, so any R3 hit is a genuine promotion rather than
a norm computed in f32 around bf16 math.  ``cfg=`` / ``attn=`` check
another config (a full-width one on the card) with the attention
projections converted too.
"""

from __future__ import annotations

import torch

from repro_torch.check.program import CheckedProgram, build_program
from repro_torch.configs import get_smoke

__all__ = ["ENTRY_NAMES", "CHECK_NM", "CHECK_GR", "check_config",
           "entry_programs"]

ENTRY_NAMES = ("serve", "decode", "prefill", "train")

#: n:m:g format + row sharing the check entries sparsify with (the fig11
#: serving format family)
CHECK_NM = (1, 4, 8)
CHECK_GR = 64

#: engine knobs the serve entries run at
CHECK_MAX_SLOTS = 4
CHECK_MAX_SEQ = 64
CHECK_DECODE_CHUNK = 4
CHECK_PROMPT_LEN = 24     # past the GEMV crossover: prefill takes the SpMM


def check_config(arch: str = "bert-base-sten"):
    """The smoke-scaled config the checker runs entries at, pinned to
    float32 (see module docstring)."""
    return get_smoke(arch).scaled(dtype="float32")


def init_params(cfg, device="cuda"):
    from repro_torch.models import init_lm

    return init_lm(cfg, 0, device=device)


def _serve_programs(arch: str, hlo: bool, device, cfg=None,
                    attn: bool = False) -> list[CheckedProgram]:
    from repro_torch.serve.engine import serve_programs, sparsify_for_serving

    cfg = cfg or check_config(arch)
    n, m, g = CHECK_NM
    sparse = sparsify_for_serving(init_params(cfg, device), n, m, g,
                                  gr=CHECK_GR, attn=attn)
    progs = serve_programs(
        sparse, cfg, max_slots=CHECK_MAX_SLOTS, max_seq_len=CHECK_MAX_SEQ,
        decode_chunk=CHECK_DECODE_CHUNK, prompt_len=CHECK_PROMPT_LEN,
    )
    out = []
    for pname, (fn, args) in progs.items():
        decode = pname.startswith("decode")
        out.append(build_program(
            f"{arch}/serve:{pname}", fn, args, model_dtype=cfg.tdtype,
            decode_path=True, loop=pname == "decode_chunk", hlo=hlo,
            decode_m=CHECK_MAX_SLOTS if decode else None,
            prefill_n=None if decode else CHECK_PROMPT_LEN,
            gated_mlp=cfg.gated_mlp,
        ))
    return out


def _train_programs(arch: str, hlo: bool, device,
                    cfg=None) -> list[CheckedProgram]:
    from repro_torch.launch.train import build_sparse_params, \
        make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = cfg or check_config(arch)
    params = build_sparse_params(init_params(cfg, device), 0.5)
    opt_state = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    batch = {k: torch.zeros((2, 16), dtype=torch.int64, device=device)
             for k in ("tokens", "labels")}
    # the graph trainer replays this step with no host sync in between:
    # a loop program
    return [build_program(
        f"{arch}/train:step", step, (params, opt_state, batch),
        model_dtype=cfg.tdtype, decode_path=False, loop=True, hlo=hlo,
        prefill_n=16,
    )]


def entry_programs(entry: str, *, arch: str = "bert-base-sten",
                   hlo: bool = True, device="cuda", cfg=None,
                   attn: bool = False) -> list[CheckedProgram]:
    """Build the CheckedPrograms of one ``--entry`` for one config on
    ``device`` (``cfg`` in place of :func:`check_config`, ``attn`` to
    convert the attention projections of the served copy too)."""
    if entry == "train":
        return _train_programs(arch, hlo, device, cfg)
    if entry not in ENTRY_NAMES:
        raise ValueError(f"unknown entry {entry!r}; pick from {ENTRY_NAMES}")
    progs = _serve_programs(arch, hlo, device, cfg, attn)
    if entry == "decode":
        return [p for p in progs if ":decode" in p.name]
    if entry == "prefill":
        return [p for p in progs if ":prefill" in p.name]
    return progs
