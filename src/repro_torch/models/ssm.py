"""Mamba2 / SSD (state-space duality) mixer [arXiv:2405.21060] (port of
``repro/models/ssm.py``).

The prefill path is the chunked SSD form: within a chunk of ``Q`` steps
the output is a decay-weighted, causally masked quadratic product (like
attention), and a state [B, H, N, P] carries the sequence from chunk to
chunk.  The reference states its intra-chunk term and the chunk states
as one four-operand einsum each; here each is a product over the chunk
axis formed as a batched matmul (``cb · L · dt`` as [B, nC, H, Q, Q]
against ``xs``), so no [B, nC, Q, Q, H, P] intermediate is ever
materialised.  The chunk-to-chunk scan is a Python loop over the host
int ``nC = ceil(S / Q)``, so a prompt length captures as one static
program.  Every SSD product runs in ``acc_dtype`` (f32), as the
reference's; TF32 must be off for them on the card.

Decode is the O(1) recurrence over the state ``{"conv": [B, W - 1, C],
"ssm": [B, H, P, N] f32}``: a rolling window of the last ``W - 1``
pre-conv inputs and the SSM state.  :func:`decode_ssm` returns the new
state, as the reference does; the transformer's decode step copies it
into the cache in place.

The projections go through ``mm``, so an n:m:g ``in_proj`` / ``out_proj``
(converted by a ``SparsityBuilder`` plan) runs the GEMV and SpMM
kernels.  Params are stacked ``[L, ...]`` like every layer leaf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import is_dtensor
from repro_torch.models.common import ModelConfig, SSMConfig, mm, \
    torch_dtype

__all__ = ["init_ssm", "apply_ssm", "decode_ssm", "init_ssm_state"]


def _rms_gated(x, z, w, eps: float = 1e-6):
    """The reference's gated RMSNorm, rounding where it rounds: the gate
    ``x * silu(z)`` in x's dtype (silu in f32, cast), the variance and
    the normalisation in f32, cast, then scaled by ``w`` itself (not the
    transformer's ``1 + w``)."""
    x = x * F.silu(z.float()).to(x.dtype)
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def init_ssm(gen: torch.Generator, cfg: ModelConfig, *, L: int, device):
    """Stacked [L, ...] mixer leaves, the reference's: ``in_proj`` packs
    [z (di), x (di), B (N), C (N), dt (H)]; the depthwise conv's weight
    (std 0.5) and zero bias; ``a_log`` 0, ``d_skip`` 1 and ``dt_bias`` 0
    in f32; the gate norm's weight 1; ``out_proj``."""
    from repro_torch.models.transformer import dense_init

    s: SSMConfig = cfg.ssm
    D, dt = cfg.d_model, cfg.tdtype
    di, H, N = s.d_inner(D), s.num_heads(D), s.state_dim
    conv_dim = di + 2 * N
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, (L, D, 2 * di + 2 * N + H), dt, device),
        "conv_w": dense_init(gen, (L, s.conv_width, conv_dim), dt, device,
                             scale=0.5),
        "conv_b": torch.zeros(L, conv_dim, dtype=dt, device=device),
        "a_log": torch.zeros(L, H, dtype=f32, device=device),
        "d_skip": torch.ones(L, H, dtype=f32, device=device),
        "dt_bias": torch.zeros(L, H, dtype=f32, device=device),
        "norm_w": torch.ones(L, di, dtype=dt, device=device),
        "out_proj": dense_init(gen, (L, di, D), dt, device),
    }


def _split_proj(proj, di: int, N: int):
    """(z, xs, B, C, dt) of the packed projection."""
    return (proj[..., :di], proj[..., di:2 * di],
            proj[..., 2 * di:2 * di + N], proj[..., 2 * di + N:2 * di + 2 * N],
            proj[..., 2 * di + 2 * N:])


def _causal_conv(x, w, b):
    """Depthwise causal conv over x [B, S, C] with w [W, C]: the taps
    summed in order in x's dtype, then the bias (the reference's Python
    ``sum`` of shifted products)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def apply_ssm(p, x, cfg: ModelConfig, return_state: bool = False):
    """x [B, S, D] -> (y [B, S, D], state or None), the full-sequence
    (prefill) path.  With ``return_state`` the state is the decode state
    after position S - 1, ``{"conv": the last W - 1 pre-conv inputs,
    "ssm": [B, H, P, N] f32}``.

    A prompt shorter than ``W - 1`` tokens has no full conv window to
    hand over, and ``return_state`` raises ``ValueError`` for it: the
    reference hands over the short tail, which its slot prefill refuses
    (an assertion) and its classic prefill writes left-aligned, where
    decode reads the window right-aligned (ROADMAP C11).  A DTensor x
    runs on each rank's batch rows (:func:`_ssm_on_local_rows`)."""
    if type(x) is not torch.Tensor and is_dtensor(x):
        return _ssm_on_local_rows(p, x, cfg, return_state)
    s: SSMConfig = cfg.ssm
    B, S, D = x.shape
    di, H, N, P = s.d_inner(D), s.num_heads(D), s.state_dim, s.head_dim
    W = s.conv_width
    if return_state and S < W - 1:
        raise ValueError(
            f"an SSM prefill of {S} tokens is shorter than conv_width - 1 "
            f"= {W - 1}: its decode state has no full conv window "
            f"(ROADMAP C11); prompts of at least {W - 1} tokens are served")
    Q = min(s.chunk, S)
    nC = -(-S // Q)
    Sp = nC * Q
    cdt = torch_dtype(s.acc_dtype)

    proj = mm(x, p["in_proj"])
    z, xs, B_, C_, dt = _split_proj(proj, di, N)
    conv_in = torch.cat([xs, B_, C_], dim=-1)
    conv_tail = conv_in[:, S - (W - 1):] if return_state else None
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs, B_, C_ = (conv_out[..., :di], conv_out[..., di:di + N],
                  conv_out[..., di + N:])

    dt = F.softplus(dt.float() + p["dt_bias"])                  # [B, S, H]
    A = -torch.exp(p["a_log"])                                   # [H] < 0

    def chunks(t, *tail):
        # padded after the softplus: pad steps have dt = 0, so they leave
        # the carried state as it is
        return F.pad(t, (0, 0) * (t.ndim - 2) + (0, Sp - S)).reshape(
            B, nC, Q, *tail)

    xs_c = chunks(xs, H, P).to(cdt)                    # [B, nC, Q, H, P]
    B_c = chunks(B_, N).to(cdt)                        # [B, nC, Q, N]
    C_c = chunks(C_, N).to(cdt)
    dt_c = chunks(dt, H)                               # [B, nC, Q, H] f32

    a_cum = torch.cumsum(dt_c * A, dim=2)              # log-decay, [.., Q, H]
    ah = a_cum.transpose(2, 3)                         # [B, nC, H, Q]
    # intra-chunk: y_i = sum_{j <= i} (C_i . B_j) exp(a_i - a_j) dt_j x_j;
    # masked after the exponential, as the reference does (above the
    # diagonal the exponent is positive and may overflow)
    iq = torch.arange(Q, device=x.device)
    causal = iq[:, None] >= iq[None, :]
    seg = ah[..., :, None] - ah[..., None, :]          # [B, nC, H, Q, Q]
    L = torch.where(causal, torch.exp(seg), torch.zeros((), device=x.device))
    cb = torch.matmul(C_c, B_c.transpose(-1, -2))      # [B, nC, Q, Q]
    M = (cb[:, :, None] * L.to(cdt)
         * dt_c.transpose(2, 3).to(cdt)[..., None, :])  # [B, nC, H, Q, Q]
    xh = xs_c.permute(0, 1, 3, 2, 4)                   # [B, nC, H, Q, P]
    y_intra = torch.matmul(M, xh).float()              # [B, nC, H, Q, P]

    # each chunk's final state: sum_j exp(a_last - a_j) dt_j B_j x_j^T
    w_end = (torch.exp(a_cum[:, :, -1:, :] - a_cum) * dt_c).to(cdt)
    xw = (xs_c * w_end[..., None]).reshape(B, nC, Q, H * P)
    states = torch.matmul(B_c.transpose(-1, -2), xw).float().reshape(
        B, nC, N, H, P).permute(0, 1, 3, 2, 4)         # [B, nC, H, N, P]
    chunk_decay = torch.exp(a_cum[:, :, -1, :])        # [B, nC, H]

    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    h_prevs = []                       # the state entering each chunk
    for c in range(nC):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)               # [B, nC, H, N, P]

    # inter-chunk: y_i += exp(a_i) C_i . h_prev
    y_inter = (torch.matmul(C_c.float()[:, :, None], h_prev)
               * torch.exp(ah)[..., None])             # [B, nC, H, Q, P]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(B, Sp, H, P)[:, :S]
    y = y + xs_c.float().reshape(B, Sp, H, P)[:, :S] \
        * p["d_skip"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    out = mm(_rms_gated(y, z, p["norm_w"]), p["out_proj"])
    if return_state:
        # the decode state's layout is [B, H, P, N]
        return out, {"conv": conv_tail, "ssm": h.transpose(-1, -2)}
    return out, None


def init_ssm_state(cfg: ModelConfig, batch: int, *, L: int, device):
    """Zero decode state stacked on [L]: ``conv`` [L, B, W - 1, C] in the
    model dtype, ``ssm`` [L, B, H, P, N] in f32."""
    s: SSMConfig = cfg.ssm
    D = cfg.d_model
    di, H, N, P = s.d_inner(D), s.num_heads(D), s.state_dim, s.head_dim
    return {
        "conv": torch.zeros((L, batch, s.conv_width - 1, di + 2 * N),
                            dtype=cfg.tdtype, device=device),
        "ssm": torch.zeros((L, batch, H, P, N), dtype=torch.float32,
                           device=device),
    }


def _ssm_on_local_rows(p, x, cfg: ModelConfig, return_state: bool):
    """:func:`apply_ssm` of DTensor x [B, S, D] on this rank's batch rows,
    every other dim gathered and the mixer's params whole (their
    gradients partial over the mesh dims that shard the batch); the output
    and state are sharded as the rows.  The chunked scan's pads, head
    splits and einsums then run on local tensors: torch 2.11's DTensor
    cannot plan the redistribute of a ``pad`` over a sharded operand,
    and cannot split heads that do not divide the mesh."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.dist.sharding import from_local, local_shard

    mesh = x.device_mesh
    rows = tuple(pl if pl.is_shard() and pl.dim == 0 else Replicate()
                 for pl in x.placements)
    whole = (Replicate(),) * mesh.ndim
    grads = tuple(Partial() if pl.is_shard() else Replicate() for pl in rows)
    pl = {k: local_shard(v, mesh, whole, grads) if is_dtensor(v) else v
          for k, v in p.items()}
    y, state = apply_ssm(pl, local_shard(x, mesh, rows), cfg, return_state)

    def wrap(t):
        return from_local(t, mesh, rows, (x.shape[0], *t.shape[1:]))

    return wrap(y), None if state is None else {
        k: wrap(v) for k, v in state.items()}


def decode_ssm(p, x, cfg: ModelConfig, state):
    """One step of the recurrence for x [B, 1, D] from ``state`` ({"conv"
    [B, W - 1, C], "ssm" [B, H, P, N]}); returns (y [B, 1, D], the new
    state), reading nothing back to the host.  The conv window's taps
    are summed in f32 and rounded once (the reference's einsum)."""
    s: SSMConfig = cfg.ssm
    B, _, D = x.shape
    di, H, N, P = s.d_inner(D), s.num_heads(D), s.state_dim, s.head_dim

    proj = mm(x, p["in_proj"])
    z, xs, B_, C_, dt = _split_proj(proj, di, N)
    conv_in = torch.cat([xs, B_, C_], dim=-1)                 # [B, 1, C]
    window = torch.cat([state["conv"], conv_in], dim=1)       # [B, W, C]
    conv = (window.float() * p["conv_w"].float()).sum(1).to(x.dtype)
    conv_out = F.silu(conv + p["conv_b"])[:, None, :]
    xs, B_, C_ = (conv_out[..., :di], conv_out[..., di:di + N],
                  conv_out[..., di + N:])

    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])          # [B, H]
    dec = torch.exp(dt * -torch.exp(p["a_log"]))
    xh = xs.reshape(B, H, P).float()
    Bf, Cf = B_[:, 0].float(), C_[:, 0].float()               # [B, N]
    h = state["ssm"] * dec[:, :, None, None] \
        + (dt[:, :, None] * xh)[..., None] * Bf[:, None, None, :]
    y = torch.matmul(h, Cf[:, None, :, None])[..., 0] \
        + xh * p["d_skip"][None, :, None]                     # [B, H, P]
    y = _rms_gated(y.reshape(B, 1, di).to(x.dtype), z, p["norm_w"])
    return mm(y, p["out_proj"]), {"conv": window[:, 1:], "ssm": h}
