"""The sharded steps (``launch/steps.py``) of the families the dry-run
grid (``launch/dryrun.py``) brought onto DTensor, against the port's
unsharded steps, on four gloo ranks at (2, 2): heads that do not divide
over the "model" axis (qwen1.5-4b and whisper-large-v3 SMOKE cut to 3
heads: ``models/attention.py:heads_view`` / ``merge_heads``, the
encoder's cross K/V), the "pjit" MoE over DTensors (moonshot-v1-16b-a3b:
``models/moe.py:apply_moe`` routes the gathered tokens), the SSM's
prefill mixer on each rank's batch rows (mamba2-370m: ``models/ssm.py:
_ssm_on_local_rows``, its state written into the sharded cache, and a
pure SSM layer's unused ``ln2``, whose gradient is zeros) and MLA's decode cache written by the rank owning each row
(minicpm3-4b at 3 heads).  SMOKE configs in f32.  Bounds as
``tests/test_torch_dist_steps.py``'s: a sharded step sums its partials in
another order, so the loss and gnorm at rtol 1e-5 (the MoE at 1e-4), the
params at rtol 1e-5 and atol lr / 16, the logits at 1e-4 and the greedy
tokens exactly."""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke
from repro_torch.launch.train import make_train_step
from repro_torch.models import decode_step, init_lm, prefill
from repro_torch.optim import AdamWConfig, adamw_init

RTOL = 1e-5
PARAM_ATOL = AdamWConfig().lr / 16
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT, CACHE_LEN, DECODE_STEPS = 12, 16, 3


def _cfg(arch, **over):
    return dataclasses.replace(get_smoke(arch), dtype="float32", **over)


#: {case: (config, kind)}; 3 heads do not divide over a "model" axis of 2
CASES = {
    "qwen_3_heads_train": (_cfg("qwen1.5-4b", n_heads=3, n_kv_heads=3),
                           "train"),
    "whisper_3_heads_train": (_cfg("whisper-large-v3", n_heads=3,
                                   n_kv_heads=3), "train"),
    "moonshot_pjit_train": (_cfg("moonshot-v1-16b-a3b"), "train"),
    "mamba2_train": (_cfg("mamba2-370m"), "train"),
    "minicpm3_3_heads_serve": (_cfg("minicpm3-4b", n_heads=3, n_kv_heads=3),
                               "serve"),
    "moonshot_pjit_serve": (_cfg("moonshot-v1-16b-a3b"), "serve"),
    "mamba2_serve": (_cfg("mamba2-370m"), "serve"),
}


def _leaves(tree):
    from tests._torch_dist_ranks import _leaves as leaves

    return dict(leaves(tree))


@pytest.fixture(scope="module")
def families_run():
    if not dist.is_gloo_available():
        pytest.skip("torch.distributed has no gloo backend")
    from repro_torch.launch.mesh import run_ranks
    from tests import _torch_dist_ranks

    rng = np.random.default_rng(21)
    vocab = get_smoke("qwen1.5-4b").vocab
    batch = {k: torch.from_numpy(rng.integers(0, vocab, (4, 8)))
             for k in ("tokens", "labels")}
    frames = torch.from_numpy(rng.standard_normal((4, 6, 64)).astype(
        np.float32))
    tokens = torch.from_numpy(rng.integers(0, vocab, (2, PROMPT)))
    cases = {name: (cfg, init_lm(cfg, seed=5, device="cpu"), kind)
             for name, (cfg, kind) in CASES.items()}
    payload = {"cases": cases, "batch": batch, "frames": frames,
               "tokens": tokens, "cache_len": CACHE_LEN,
               "steps": DECODE_STEPS}
    sharded = run_ranks(_torch_dist_ranks.families, 4, payload)[0]
    return payload, sharded


@pytest.mark.parametrize("case", [c for c, (_, k) in CASES.items()
                                  if k == "train"])
def test_sharded_train_step_equals_unsharded(families_run, case):
    payload, sharded = families_run
    cfg, params, _ = payload["cases"][case]
    batch = dict(payload["batch"])
    if cfg.n_enc_layers > 0:
        batch["enc_embeds"] = payload["frames"]
    step = make_train_step(cfg, AdamWConfig())
    p = copy.deepcopy(params)      # the step updates its params in place
    p, _, m = step(p, adamw_init(p), batch)
    rtol = 1e-4 if cfg.moe is not None else RTOL
    got = sharded[case]
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(got["metrics"][k], float(m[k]),
                                   rtol=rtol, err_msg=f"{case} {k}")
    want = _leaves(p)
    assert set(got["params"]) == set(want)
    for path, t in want.items():
        np.testing.assert_allclose(got["params"][path].numpy(), t.numpy(),
                                   rtol=RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{case} {path}")


@pytest.mark.parametrize("case", [c for c, (_, k) in CASES.items()
                                  if k == "serve"])
def test_sharded_prefill_and_decode_equal_unsharded(families_run, case):
    payload, sharded = families_run
    cfg, params, _ = payload["cases"][case]
    logits, cache = prefill(params, cfg, payload["tokens"],
                            payload["cache_len"])
    want = [logits[:, -1] if logits.ndim == 3 else logits]
    pos = payload["tokens"].shape[1]
    for i in range(payload["steps"]):
        tok = want[-1].argmax(-1)[:, None].int()
        logits, cache = decode_step(params, cfg, tok, cache, pos + i)
        want.append(logits)
    got = sharded[case]["logits"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.argmax(-1), w.argmax(-1)), case
        np.testing.assert_allclose(g.numpy(), w.numpy(), **LOGIT_TOL,
                                   err_msg=case)
