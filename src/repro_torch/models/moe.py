"""Mixture-of-Experts FFN with capacity-buffer dispatch (port of
``repro/models/moe.py``: ``init_moe``, ``apply_moe`` with its three
combines, and the expert-parallel ``apply_moe_shmap``).

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

The ``scatter`` combine is the reference's reverse dispatch: each kept
slot's token and gate are written into [E, cap + 1] tables whose row
``cap`` is a sink for every slot past capacity (the reference's
``mode="drop"``: the pattern the paged pool uses, ROADMAP C2), and the
expert rows, weighted, are added into [T, D] by token.  On the CPU the
adds run in row order; on the card ``index_add_`` adds with atomics, so
the scatter combine's last bits may move from run to run there, unlike
the gather combine's.  The four ``logical_constraint`` sites are the
reference's; each is the identity on plain tensors.

:func:`apply_moe_shmap` is the reference's expert parallelism without
token movement: under an active mesh with a "model" axis whose size
divides E, each rank routes its local tokens, runs its ``E / ep``
experts on ``to_local`` shards and the partial outputs are summed over
"model" (a functional all-reduce); otherwise it is :func:`apply_moe`,
as in the reference.

The expert products stay ``torch.bmm``: the reference computes them
outside any Pallas kernel.  :func:`route_log` records each call's router
probabilities and expert choice, and replays a recorded choice in
another run; checks use it to compare two runs on the same routes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from repro_torch.dist.sharding import active_rules, from_local, \
    is_dtensor, local_shard, logical_constraint, mesh_axes, placements_of
from repro_torch.kernels.nmg_fused import act_fn
from repro_torch.models.common import ModelConfig, MoEConfig, mm

__all__ = ["init_moe", "apply_moe", "apply_moe_shmap", "capacity",
           "route_log", "RouteLog"]


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
    load-balancing loss).  A DTensor x (the sharded steps' "pjit" MoE)
    is gathered whole and routed, dispatched and combined on every rank
    as one device does it, as the reference's GSPMD program routes the
    global batch (one capacity from the global token count); only the
    dispatch buffer and the expert products are DTensors, sharded by
    expert as the weights are, and the output is sharded as x.  The
    routing runs on local tensors: torch 2.11's DTensor has no
    ``index_copy_`` and mis-shards ``index_select``'s backward."""
    mc: MoEConfig = cfg.moe
    B, S, D = x.shape
    E, k = mc.num_experts, mc.top_k
    T = B * S
    x_in, mesh, router = x, None, p["router"]
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        whole = (Replicate(),) * mesh.ndim
        x, router = (local_shard(t, mesh, whole) for t in (x, router))
    x2 = x.reshape(T, D)

    probs = _router_probs(x2, router)                       # [T, E]
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
    if mesh is not None:
        buf = from_local(buf, mesh, whole, buf.shape)
    buf = logical_constraint(buf, ("expert", None, None))

    # the experts as two batched products (the reference's einsums
    # ecd,edf->ecf and ecf,efd->ecd)
    h = _gated(torch.bmm(buf, p["wi"]), cfg)
    out_buf = torch.bmm(h, p["wo"])
    out_buf = logical_constraint(out_buf, ("expert", None, None))

    if mc.combine == "replicated":
        out_buf = logical_constraint(out_buf, (None, None, None))
    if mesh is not None:
        out_buf = local_shard(out_buf, mesh, whole)
    if mc.combine == "scatter":
        y = _scatter_combine(out_buf, flat_e, pos, keep, gates, T, cap)
    else:
        # gather ("replicated" is the same on one device): a token's k
        # slots summed in f32 in slot order
        src = flat_e * cap + torch.where(keep, pos, cap - 1)
        slot_out = out_buf.reshape(E * cap, D).index_select(0, src)
        slot_out = torch.where(keep[:, None], slot_out,
                               torch.zeros_like(slot_out))
        w = (gates.reshape(-1) * keep).float()[:, None]
        y = (slot_out.float() * w).view(T, k, D).sum(1)

    if log is not None:
        log.calls.append({"probs": probs.detach(), "eidx": eidx,
                          "keep": keep.view(T, k)})
    if mesh is None:
        if mc.dense_residual:
            y = y + _residual(p, x2, cfg)
        return y.reshape(B, S, D).to(x.dtype), aux
    # x's token shards (a partial x's mesh dims replicated); arctic's
    # residual MLP on x itself, on the sharded params; the aux loss a
    # replicated DTensor, so its gradient enters the local graph local
    aux = from_local(aux, mesh, whole, ())
    y = from_local(y.reshape(B, S, D), mesh, whole, (B, S, D)).redistribute(
        mesh, tuple(Replicate() if pl.is_partial() else pl
                    for pl in x_in.placements))
    if mc.dense_residual:
        y = y + _residual(p, x_in.reshape(T, D), cfg).reshape(B, S, D)
    return y.to(x.dtype), aux


def _residual(p, x2, cfg: ModelConfig) -> torch.Tensor:
    """Arctic's dense residual MLP over x2 [T, D], in f32."""
    hr = _gated(mm(x2, p["res_wi"]), cfg)
    return mm(hr, p["res_wo"]).float()


def _scatter_combine(out_buf, flat_e, pos, keep, gates, T: int, cap: int):
    """The reference's ``scatter`` combine: each kept slot's token and
    gate into [E, cap + 1] tables (row ``cap`` the sink of every slot past
    capacity, the reference's ``mode="drop"``), then the expert rows
    weighted by their gates added into [T, D] f32 by token (an empty slot
    adds a zero row to token 0, as in the reference)."""
    E, _, D = out_buf.shape
    dst = flat_e * (cap + 1) + torch.where(keep, pos, cap)
    tok = torch.arange(T, device=out_buf.device).repeat_interleave(
        flat_e.shape[0] // T)
    slot_token = torch.zeros(E * (cap + 1), dtype=torch.long,
                             device=out_buf.device).index_copy_(0, dst, tok)
    slot_gate = torch.zeros(E * (cap + 1), dtype=torch.float32,
                            device=out_buf.device).index_copy_(
        0, dst, (gates.reshape(-1) * keep).float())
    slot_token = slot_token.view(E, cap + 1)[:, :cap]
    slot_gate = slot_gate.view(E, cap + 1)[:, :cap]
    contrib = out_buf.float() * slot_gate[..., None]
    y = torch.zeros((T, D), dtype=torch.float32, device=out_buf.device)
    y.index_add_(0, slot_token.reshape(-1), contrib.reshape(E * cap, D))
    return logical_constraint(y, ("batch", None))


def apply_moe_shmap(p, x: torch.Tensor, cfg: ModelConfig):
    """Expert parallelism with no token movement (the reference's
    ``apply_moe_shmap``): the batch is replicated over "model", so every
    model-rank (1) routes its local tokens (the same choice on every
    rank), (2) dispatches only the slots of its ``E / ep`` experts into a
    local capacity buffer (``max(8, ...)`` slots, the reference's), (3)
    runs its experts, (4) combines locally and (5) all-reduces the
    partial outputs over "model"; the auxiliary loss is averaged over the
    data-parallel axes.  Arctic's dense residual runs outside, on the
    sharded params.  Without active rules, without a "model" axis, or
    when ep does not divide E, it is :func:`apply_moe`, as in the
    reference.  Returns (out in x.dtype, aux)."""
    ctx = active_rules()
    mc: MoEConfig = cfg.moe
    if ctx is None or "model" not in mesh_axes(ctx[0]):
        return apply_moe(p, x, cfg)
    mesh = ctx[0]
    axes = mesh_axes(mesh)
    ep = axes["model"]
    E, k = mc.num_experts, mc.top_k
    if E % ep != 0:
        return apply_moe(p, x, cfg)
    from torch.distributed.tensor import Partial, Replicate

    # the data-parallel axes the batch is sharded over (a plain x, the
    # same on every rank, is taken whole)
    dp = tuple(a for a in ("pod", "data") if a in axes) \
        if is_dtensor(x) else ()
    E_loc = E // ep
    B, S, D = x.shape
    x_pl = placements_of((dp or None,), mesh)
    w_pl = placements_of(("model",), mesh)

    def part(pl, over):
        """``pl`` with ``Partial`` on the mesh dims of ``over``: each of
        their ranks holds part of a gradient (its tokens, its experts)."""
        return tuple(Partial() if a in over else q
                     for a, q in zip(axes, pl))

    x_loc = local_shard(x, mesh, x_pl, part(x_pl, ("model",)))
    router = local_shard(p["router"], mesh, placements_of((), mesh),
                         part(placements_of((), mesh), dp + ("model",)))
    wi, wo = (local_shard(p[n], mesh, w_pl, part(w_pl, dp))
              for n in ("wi", "wo"))

    Bl = x_loc.shape[0]
    T = Bl * S
    x2 = x_loc.reshape(T, D)
    probs = _router_probs(x2, router)
    gates, eidx = torch.sort(probs, stable=True, dim=-1, descending=True)
    gates, eidx = gates[:, :k], eidx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    assign = torch.zeros((T, E), dtype=torch.int32, device=x2.device)
    assign.scatter_(1, eidx, 1)
    aux = E * (probs.mean(0) * (assign.float().mean(0) / k)).sum()

    # this rank's experts: [lo, lo + E_loc)
    lo = mesh.get_local_rank(list(axes).index("model")) * E_loc
    flat_e = eidx.reshape(-1)
    mine = (flat_e >= lo) & (flat_e < lo + E_loc)
    le = torch.where(mine, flat_e - lo, torch.zeros_like(flat_e))
    cap = max(8, int(T * k / E * mc.capacity_factor))
    cap = -(-cap // 8) * 8
    # rank within the local expert: exclusive cumsum over the slots
    onehot = torch.nn.functional.one_hot(le, E_loc).int() * mine[:, None]
    pos = (torch.cumsum(onehot, 0, dtype=torch.int32) - onehot).gather(
        1, le[:, None])[:, 0]
    keep = mine & (pos < cap)
    dst = le * (cap + 1) + torch.where(keep, pos, cap)
    buf = x2.new_zeros((E_loc * (cap + 1), D))
    buf.index_copy_(0, dst, x2[:, None].expand(T, k, D).reshape(T * k, D))
    buf = buf.view(E_loc, cap + 1, D)[:, :cap]
    h = _gated(torch.bmm(buf, wi), cfg)
    out_buf = torch.bmm(h, wo).reshape(E_loc * cap, D)
    src = le * cap + torch.where(keep, pos, torch.zeros_like(pos))
    slot_out = out_buf.index_select(0, src)
    slot_out = torch.where(keep[:, None], slot_out,
                           torch.zeros_like(slot_out))
    w = (gates.reshape(-1) * keep).float()[:, None]
    y = (slot_out.float() * w).view(T, k, D).sum(1).reshape(Bl, S, D)
    # the partial outputs summed over "model", the aux loss averaged over
    # the data-parallel ranks, as DTensor redistributes (so gradients
    # flow): every model rank computes the same aux, so each adds 1/ep
    y = from_local(y, mesh, part(x_pl, ("model",)),
                   (B, S, D)).redistribute(mesh, x_pl)
    n = ep * math.prod(axes[a] for a in dp)
    aux = from_local(aux / n, mesh, part(placements_of((), mesh),
                                         dp + ("model",)), ()).redistribute(
        mesh, (Replicate(),) * mesh.ndim)
    if not is_dtensor(x):
        y, aux = y.to_local(), aux.to_local()
    if mc.dense_residual:
        # the dense residual MLP outside the expert-parallel body, on the
        # sharded params (the reference keeps it in pjit-land)
        y = y + _residual(p, x.reshape(-1, D), cfg).reshape(B, S, D)
    return y.to(x.dtype), aux
