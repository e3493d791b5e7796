"""Mixture-of-Experts FFN with capacity-buffer dispatch (port of
``init_moe`` and ``apply_moe`` in ``repro/models/moe.py``; the
expert-parallel ``apply_moe_shmap`` waits for distribution).

Step for step as the reference: an f32 router and its softmax, the top-k
experts of each token with their gates renormalised, the Switch-style
auxiliary loss, a static capacity ``cap`` per expert, each (token, slot)
ranked within its expert by an exclusive cumsum over the [T, E]
assignment in token order, the kept slots scattered into a zeroed
[E, cap, D] buffer, the experts as two batched products with the gated
activation between them, and the gather combine summed in f32 with the
gates.  Arctic's dense residual MLP runs beside the experts.

What the port adds, and why:

- **Ties.** ``jax.lax.top_k`` puts the lower expert index first among
  equal probabilities; ``torch.topk`` promises no order.  A stable
  descending sort and its first k columns keep the reference's rule.
- **The router in full f32.** A TF32 product changes routes, so the
  router's product runs with TF32 off whatever the process's setting.
- **Capture.** Nothing reads the device from the host: ``cap`` comes from
  the static token count T (the engine's slot count at decode, the prompt
  length at an admission; idle slots route too, as in the reference), and
  every shape is static, so a decode step or an admission with MoE
  layers captures as a CUDA graph.
- **Determinism.** A dropped slot is written to a spare row ``cap`` of
  its expert (the reference adds a zero into row ``cap - 1``, a
  collision with a kept slot that a scatter without accumulation would
  race on), so the kept (expert, rank) pairs are unique and the dispatch
  is a plain indexed copy.  The combine sums a token's k slots as
  ``[T, k, D].sum(1)``, a fixed order, not with float atomics: a replay
  equals the eager run bit for bit.

The expert products stay ``torch.bmm``: the reference computes them
outside any Pallas kernel.  :func:`route_log` records each call's router
probabilities and expert choice, and replays a recorded choice in
another run; checks use it to compare two runs on the same routes.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels.nmg_fused import act_fn
from repro_torch.models.common import ModelConfig, MoEConfig, mm

__all__ = ["init_moe", "apply_moe", "capacity", "route_log", "RouteLog"]


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, L: int, device):
    """Stacked [L, ...] MoE leaves, the reference's: ``router`` f32 [D, E],
    ``wi`` [E, D, 2F] (F without a gated MLP), ``wo`` [E, F, D], and with
    ``dense_residual`` ``res_wi`` [D, 2Fr] and ``res_wo`` [Fr, D];
    truncated-normal fan-in init, each leaf drawn a layer at a time.

    A deliberate difference: the reference's ``dense_init`` takes a leaf's
    first axis as its fan-in, which for its per-layer expert leaves is E,
    so its ``wi`` and ``wo`` have std 1/sqrt(E) (1/8 at 64 experts).  Each
    expert product then has sqrt(D/E) times a fan-in init's gain, each
    MoE sublayer returns about a hundred times its normed input, and a
    deep bf16 model carries one rounding step at its input past any logit
    tolerance.  The port draws ``wi`` and ``wo`` with their own fan-in,
    D and F, as every other leaf; the router and the residual MLP have
    the reference's scale."""
    from repro_torch.models.transformer import dense_init

    mc: MoEConfig = cfg.moe
    D, E, F, dt = cfg.d_model, mc.num_experts, mc.d_expert, cfg.tdtype
    gated = 2 if cfg.gated_mlp else 1
    p = {"router": dense_init(gen, (L, D, E), torch.float32, device),
         "wi": dense_init(gen, (L, E, D, gated * F), dt, device),
         "wo": dense_init(gen, (L, E, F, D), dt, device)}
    if mc.dense_residual:
        Fr = mc.dense_residual_ff or F
        p["res_wi"] = dense_init(gen, (L, D, gated * Fr), dt, device)
        p["res_wo"] = dense_init(gen, (L, Fr, D), dt, device)
    return p


def capacity(T: int, mc: MoEConfig) -> int:
    """Slots per expert for T tokens: the reference's Python expression,
    in its order, rounded up to a multiple of 8."""
    cap = max(1, int(T * mc.top_k / mc.num_experts * mc.capacity_factor))
    return -(-cap // 8) * 8


class RouteLog:
    """What each :func:`apply_moe` call routed, in call order: ``calls``
    holds one dict a call, ``probs`` [T, E] f32, ``eidx`` [T, k] (the
    experts taken) and ``keep`` [T, k] (the slots within capacity).  With
    ``pin`` (a list of [T, k] expert choices, one a call, as ``routes``
    gives them) call i takes ``pin[i]`` in place of its own top-k, its
    gates its own probabilities of those experts, renormalised."""

    def __init__(self, pin=None):
        self.pin = None if pin is None else list(pin)
        self.calls: list = []

    @property
    def routes(self) -> list:
        return [c["eidx"] for c in self.calls]


_LOG: Optional[RouteLog] = None


@contextlib.contextmanager
def route_log(pin=None):
    """While inside, every :func:`apply_moe` call is recorded in the
    yielded :class:`RouteLog` (and, with ``pin``, routed as it says).
    For checks run eagerly: a graph replay records nothing."""
    global _LOG
    prev, _LOG = _LOG, RouteLog(pin)
    try:
        yield _LOG
    finally:
        _LOG = prev


def _router_probs(x2: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """softmax(x2 in f32 @ router) [T, E], the product in full f32."""
    xf = x2.float()
    if xf.is_cuda:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            logits = xf @ router
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    else:
        logits = xf @ router
    return torch.softmax(logits, dim=-1)


def _gated(h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.gated_mlp:
        u, v = h.chunk(2, dim=-1)
        return act_fn(cfg.act)(u) * v
    return act_fn(cfg.act)(h)


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig):
    """x [B, S, D] -> (out [B, S, D] in x.dtype, aux: the f32 Switch
    load-balancing loss)."""
    mc: MoEConfig = cfg.moe
    B, S, D = x.shape
    E, k = mc.num_experts, mc.top_k
    T = B * S
    x2 = x.reshape(T, D)

    probs = _router_probs(x2, p["router"])                  # [T, E]
    log = _LOG
    if log is not None and log.pin is not None:
        eidx = log.pin[len(log.calls)].to(probs.device)
        assert eidx.shape == (T, k), (eidx.shape, T, k)
        gates = probs.gather(1, eidx)
    else:
        gates, eidx = torch.sort(probs, stable=True, dim=-1,
                                 descending=True)
        gates, eidx = gates[:, :k], eidx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # the Switch load-balancing loss; ``assign`` [T, E] counts each
    # token's slots per expert (a token's k experts are distinct)
    assign = torch.zeros((T, E), dtype=torch.int32, device=x.device)
    assign.scatter_(1, eidx, 1)
    me = probs.mean(0)
    ce = assign.float().mean(0) / k
    aux = E * (me * ce).sum()

    cap = capacity(T, mc)
    # rank of each (token, slot) within its expert: exclusive cumsum in
    # token order
    ranks_base = torch.cumsum(assign, 0, dtype=torch.int32) - assign
    flat_e = eidx.reshape(-1)                                # [T*k]
    pos = ranks_base.gather(1, eidx).reshape(-1)
    keep = pos < cap

    # dispatch: kept slots into [E, cap, D], dropped ones into a spare row
    buf = x2.new_zeros((E * (cap + 1), D))
    dst = flat_e * (cap + 1) + torch.where(keep, pos, cap)
    buf.index_copy_(0, dst, x2[:, None].expand(T, k, D).reshape(T * k, D))
    buf = buf.view(E, cap + 1, D)[:, :cap]

    # the experts as two batched products (the reference's einsums
    # ecd,edf->ecf and ecf,efd->ecd)
    h = _gated(torch.bmm(buf, p["wi"]), cfg)
    out_buf = torch.bmm(h, p["wo"]).reshape(E * cap, D)

    # combine (gather; "replicated" is the same on one device): a token's
    # k slots summed in f32 in slot order
    src = flat_e * cap + torch.where(keep, pos, cap - 1)
    slot_out = out_buf.index_select(0, src)
    slot_out = torch.where(keep[:, None], slot_out,
                           torch.zeros_like(slot_out))
    w = (gates.reshape(-1) * keep).float()[:, None]
    y = (slot_out.float() * w).view(T, k, D).sum(1)

    if mc.dense_residual:
        hr = _gated(mm(x2, p["res_wi"]), cfg)
        y = y + mm(hr, p["res_wo"]).float()

    if log is not None:
        log.calls.append({"probs": probs.detach(), "eidx": eidx,
                          "keep": keep.view(T, k)})
    return y.reshape(B, S, D).to(x.dtype), aux
