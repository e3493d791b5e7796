"""The ported LM stack: a decoder with GQA or MLA attention, a Mamba2
SSD mixer (``models/ssm.py``) or both side by side, and a plain or gated
MLP or a mixture of experts, optionally behind a prefix of precomputed
embeddings (port of the dense decoder, MoE, SSM, hybrid and VLM-prefix
paths of ``repro/models/transformer.py``).

Params are nested dicts with the reference's layout: layer leaves are
stacked on a leading ``[L]`` axis, and a Python loop over ``L`` indexes
them where the reference scans (a stacked layout is sliced per layer, a
view).  A config with ``layer_pattern == "alt_local_global"`` (gemma2)
holds the reference's pair layout, ``layers = {"local": {...}, "global":
{...}}``, each stacked on ``[L/2]``; the loop walks the pairs, local
first, as the reference's scan over pairs does.  Local layers attend over
``cfg.local_window`` keys; ``attn_softcap`` / ``logit_softcap`` cap the
attention scores and the logits, and ``post_norms`` norms each
sublayer's output before its residual add.  ``prefix_embeds`` [B, P, D]
(paligemma's stub vision frontend) are prepended to the scaled token
embeddings, unscaled, and every layer attends bidirectionally over those
P positions (the prefix-LM mask).  An MLA layer (``attn_type == "mla"``,
minicpm3) caches the compressed latent ``{"ckv", "kr"}`` in place of
``{"k", "v"}`` and decodes by the absorbed-latent attention.  A config
with ``cfg.moe`` (moonshot, arctic) holds a ``moe`` subtree in place of
``mlp`` in every layer (``models/moe.py``); ``forward(with_aux=True)``
and ``loss_fn`` sum its per-layer auxiliary loss as the reference's
layer scan does.  ``attn_type "none"`` (mamba2) gives each layer an
``ssm`` mixer in place of attention and no MLP; ``"hybrid"`` (hymba) an
``ssm`` beside GQA attention on the same normed input, mixed as ``(a +
s) * 0.5``.  With ``layer_pattern "local"`` every layer attends over
``local_window`` keys.  An enc-dec config (``n_enc_layers > 0``,
whisper) runs ``enc_layers``, the same layer body non-causal, over
``enc_embeds`` [B, F, D] (precomputed frames, the reference's stub
frontend) and ``enc_norm``; each decoder layer then cross-attends over
the encoder's output after its self-attention (``xattn`` behind its own
norm ``lnx``: no RoPE, no fused QKV, f32 scores, as the reference's
``_cross_attn``).  Any projection may be a ``GroupedNMTensor`` (``mm``
routes it through the n:m:g kernels) or another layout
(``FixedMaskTensor`` in masked training; ``NMTensor`` and
``DenseTensor`` through the dispatcher's lossless conversions).  The reference's three intermediate tag sites
are here (``attn.out`` in the forward and prefill, ``mlp.act`` and
``mlp.out`` in every FFN): with no sparsity plan active ``tag`` returns
its input itself, so they change nothing then.  With
``cfg.mlp_inline_threshold`` the MLP up-projection carries the
scalar-threshold inline sparsifier: on a dense ``mlp.wi`` it runs the
fused ``matmul_threshold`` kernel.  ``forward`` and ``loss_fn``
are autograd-safe (the training path) and take the reference's ``remat``:
``"full"`` runs each layer body (a pair's two layers, as the reference's
scan body) under ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``, whose recompute gives the same bits as the
saved activations.  The default is ``"none"`` where the reference's is
``"full"``: the reference's own trainer and serving pass ``"none"``, and
only the sharded step programs (``launch/steps.py``) turn it on.

Under an active mesh (``dist/sharding.py:use_rules``) params and
activations may be DTensors.  The reference's ``logical_constraint``
sites are here (the encoder's input, the embeddings before the first
layer, the decode step's token embeddings): on plain tensors, and with
no rules active, each is the identity.

The KV cache ``{"k", "v"}`` ([L, B, S, KV, hd]; for a pair layout
``{"local": {"k", "v"}, "global": {...}}`` on [L/2], the local leaves a
ring of ``min(S, local_window)`` rows, or full length with
``init_cache(local_window_cache=False)``; for MLA ``{"ckv" [L, B, S, r],
"kr" [L, B, S, rd]}``; an SSM's recurrent state ``{"ssm_state":
{"conv", "ssm"}}``, which has no sequence axis; an enc-dec model's cross
K/V ``{"xk", "xv"}`` [L, B, enc_len, KV, hd], sized by the frames, written
whole at admission and only read by decode) is updated **in place**
(``index_put_`` / ``index_copy_``) where the reference returns a new
array from ``.at[].set``; ``decode_step`` and ``prefill`` still return the
cache for the reference's calling convention.  The serving engine's decode
and admission graphs (``serve/graphs.py``) replay against these very
tensors, so no path may reallocate them, and neither the decode step
nor slot prefill reads anything from the host (positions, slot and
write offset may be device tensors).  A ring leaf takes position ``p`` at
row ``p % S_cache``; a state leaf is overwritten whole (the decode step
copies the new state into it, an admission writes its slot's).  Decode
writes past the end of a full-length leaf
are clamped onto its last row where the reference drops them: only a
slot that already finished writes there (its tokens are discarded on the
host), and a later occupant rewrites every row before reading it.
With ``cfg.kv_cache_dtype`` the K/V and MLA latent leaves are stored in
that dtype: ``"int8"`` holds the reference's static-scale codes
(:data:`KV_QUANT_SCALE`).  Every cache write goes through
:func:`_to_cache_dtype` and decode reads int8 leaves back through
:func:`_dq_cache`, in the model dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.builder import tag
from repro_torch.core.layouts import FixedMaskTensor, GroupedNMTensor
from repro_torch.core.sparsifiers import ScalarThresholdSparsifier
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import from_local, is_dtensor, \
    local_range, local_shard, logical_constraint
from repro_torch.kernels.nmg_fused import act_fn
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import KV_CACHE_DTYPES, ModelConfig, mm, \
    mm_gated

__all__ = ["init_lm", "forward", "logits_of", "loss_fn", "init_cache",
           "decode_step", "prefill", "prefill_into_slot", "dense_init",
           "layer_params", "layer_list", "cache_leaves", "map_cache"]


def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init drawn from ``gen`` in f32, scaled
    and cast to ``dtype``; stacked [L, fan_in, fan_out] shapes use the
    per-layer fan-in.  A stacked shape is drawn one layer at a time into
    f32 scratch of one layer's shape, scaled in place and cast into the
    preallocated [L, ...] result: init's peak is the params plus one
    layer's scratch (drawn whole, starcoder2-15b's ``mlp.wi`` would take
    24 GB of f32 and as much again for its scaled copy).  On the ``meta``
    device it draws nothing (``gen`` may be None): the leaf's shape and
    dtype alone."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))

    def draw(t):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return t.mul_(std)

    if len(shape) < 3:
        return draw(torch.empty(shape, dtype=torch.float32,
                                device=device)).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    scratch = torch.empty(shape[1:], dtype=torch.float32, device=device)
    for i in range(shape[0]):
        out[i].copy_(draw(scratch))
    return out


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
         ) -> torch.Tensor:
    """RMSNorm with the reference's ``1 + w`` scale, computed in f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def _pair(cfg: ModelConfig) -> bool:
    return cfg.layer_pattern == "alt_local_global"


def _groups(cfg: ModelConfig) -> tuple:
    """The layer groups of one body in depth order: ("local", "global")
    for a pair layout, (None,) for a plain stack."""
    return ("local", "global") if _pair(cfg) else (None,)


def _group(tree, g):
    return tree if g is None else tree[g]


def _is_local(cfg: ModelConfig, g) -> bool:
    """Whether the layers of group ``g`` attend over a sliding window: a
    pair layout's local group, or every layer of an all-local model."""
    return g == "local" or cfg.layer_pattern == "local"


def _stack(trees: list):
    """The per-layer contributions (tensors, or dicts of them such as an
    SSM's ``{"conv", "ssm"}``) stacked on a new leading [L] axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _init_layers(gen, cfg: ModelConfig, L: int, dev, *, cross=False):
    """One stack of L layers, the reference's leaves: ``attn`` for GQA,
    MLA and the hybrid, ``ssm`` for an SSM or hybrid model, ``moe`` in
    place of ``mlp`` for a MoE config, no ``mlp`` in an attention-free
    (pure SSM) layer; with ``cross`` (an enc-dec decoder) the
    cross-attention ``xattn`` and its norm ``lnx``."""
    D, F_, dt = cfg.d_model, cfg.d_ff, cfg.tdtype
    p: dict[str, Any] = {
        "ln1": torch.zeros(L, D, dtype=dt, device=dev),
        "ln2": torch.zeros(L, D, dtype=dt, device=dev),
    }
    if cfg.attn_type in ("gqa", "hybrid"):
        p["attn"] = attn.init_gqa(gen, cfg, L=L, device=dev)
    elif cfg.attn_type == "mla":
        p["attn"] = attn.init_mla(gen, cfg, L=L, device=dev)
    if cfg.attn_type in ("none", "hybrid"):
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, L=L, device=dev)
    if cfg.moe is not None:
        p["moe"] = moe_mod.init_moe(gen, cfg, L=L, device=dev)
    elif cfg.attn_type != "none":
        p["mlp"] = {"wi": dense_init(
            gen, (L, D, 2 * F_ if cfg.gated_mlp else F_), dt, dev),
            "wo": dense_init(gen, (L, F_, D), dt, dev)}
    if cross:
        p["xattn"] = attn.init_gqa(gen, cfg, L=L, device=dev)
        p["lnx"] = torch.zeros(L, D, dtype=dt, device=dev)
    if cfg.post_norms:
        p["post_ln1"] = torch.zeros(L, D, dtype=dt, device=dev)
        p["post_ln2"] = torch.zeros(L, D, dtype=dt, device=dev)
    return p


def init_lm(cfg: ModelConfig, seed: int = 0, *, device="cuda"):
    """Random params for ``cfg`` from a seeded ``torch.Generator`` on
    ``device``, in the reference's layout (a pair layout for
    ``alt_local_global``; an enc-dec config's ``enc_layers`` and
    ``enc_norm`` beside the decoder's ``layers``, which hold ``xattn``
    and ``lnx``; different numbers: the reference draws from
    ``jax.random``), each stacked leaf drawn a layer at a time.  With
    ``device="meta"`` the leaves have their shapes and dtypes and nothing
    is drawn or allocated (the counterpart of the reference's
    ``jax.eval_shape(init_lm)``)."""
    cfg.validate()
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    D, L, dt = cfg.d_model, cfg.n_layers, cfg.tdtype
    params: dict[str, Any] = {
        "embedding": dense_init(gen, (cfg.vocab, D), dt, dev, scale=1.0),
        "final_norm": torch.zeros(D, dtype=dt, device=dev),
    }
    if _pair(cfg):
        params["layers"] = {g: _init_layers(gen, cfg, L // 2, dev)
                            for g in _groups(cfg)}
    else:
        params["layers"] = _init_layers(gen, cfg, L, dev,
                                        cross=cfg.n_enc_layers > 0)
    if cfg.n_enc_layers > 0:
        params["enc_layers"] = _init_layers(gen, cfg, cfg.n_enc_layers, dev)
        params["enc_norm"] = torch.zeros(D, dtype=dt, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (D, cfg.vocab), dt, dev)
    return params


def layer_params(layers, i: int):
    """Layer ``i`` of the stacked layer tree (views, no copies): the
    decode step's per-layer slice."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    if isinstance(layers, torch.Tensor):
        return layers[i]
    if isinstance(layers, FixedMaskTensor):
        return FixedMaskTensor(layers.val[i], layers.mask[i], layers.origin)
    if isinstance(layers, GroupedNMTensor):
        return layers.layer(i)
    return layers.unbind(0)[i]


def layer_list(layers) -> list:
    """Every layer of the stacked layer tree, as views.  Tensors and
    layouts (a ``FixedMaskTensor``'s val and mask, an ``NMTensor``'s val
    and idx, ...) are unbound once, so autograd carries the per-layer
    gradients back into each stacked leaf with one stack rather than one
    full-size scatter per layer."""
    if isinstance(layers, dict):
        parts = {k: layer_list(v) for k, v in layers.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(layers, GroupedNMTensor):
        return [layers.layer(i) for i in range(layers.val.shape[0])]
    return list(layers.unbind(0))


def _lookup(table, tokens) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table (vocab-sharded under the
    rules) is gathered whole and indexed on each rank's own tokens, the
    result sharded as the tokens are: every rank's rows, one local
    gather, and a backward that is the one-card one per rank (its
    gradient summed over the token shards, then re-sharded as the
    table).  DTensor's own indexing of the sharded table is not used:
    torch 2.11 cannot propagate its backward's ``index_put`` (a
    ``Partial`` gradient)."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    whole = table.redistribute(mesh, (Replicate(),) * mesh.ndim)
    shape = (*tokens.shape, table.shape[1])
    if not is_dtensor(tokens):
        return from_local(whole.to_local()[tokens], mesh,
                          (Replicate(),) * mesh.ndim, shape)
    rows = tuple(p if p.is_shard() else Replicate()
                 for p in tokens.placements)
    tokens = tokens.redistribute(mesh, rows)
    grads = tuple(Partial() if p.is_shard() else Replicate() for p in rows)
    x = whole.to_local(grad_placements=grads)[tokens.to_local()]
    return from_local(x, mesh, tuple(
        Shard(p.dim) if p.is_shard() else p for p in rows), shape)


def _embed(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    x = _lookup(params["embedding"], tokens)
    # the scale is rounded to the activation dtype first, then multiplied
    # (one rounding of the exact product, as dtype * dtype would give)
    scale = float(torch.tensor(math.sqrt(1.0 * cfg.d_model),
                               dtype=torch.float32).to(x.dtype))
    return x * scale


def _sublayer_attn(lp, x, cfg, *, is_local=False, prefix_len=0,
                   collect=False, causal=True, enc_out=None):
    """The mixer sublayer: attention, the SSM mixer, or (hybrid) the mean
    of both, ``(a + s) * 0.5`` in the activation dtype; then, in an
    enc-dec decoder layer (``enc_out`` given), the cross-attention over
    the encoder's output, ``x + xattn(rms(x, lnx))``.  Returns (x, this
    layer's cache contribution: {"k", "v"}, MLA's {"ckv", "kr" [B, S,
    rd]}, the cross K/V {"xk", "xv"} [B, F, KV, hd], and an SSM's
    {"ssm_state": {"conv", "ssm"}}, the latter only with ``collect``).
    ``causal`` false: every position attends over every other (the
    encoder)."""
    h = _rms(x, lp["ln1"])
    contrib: dict[str, Any] = {}
    a = None
    if cfg.attn_type == "mla":
        a, ckv, kr = attn.apply_mla(lp["attn"], h, cfg, causal=causal)
        contrib = {"ckv": ckv, "kr": kr.reshape(kr.shape[0], kr.shape[1], -1)}
    elif "attn" in lp:
        a, (k, v) = attn.apply_gqa(lp["attn"], h, cfg, is_local=is_local,
                                   prefix_len=prefix_len, causal=causal)
        contrib = {"k": k, "v": v}
    if "ssm" in lp:
        s_out, state = ssm_mod.apply_ssm(lp["ssm"], h, cfg,
                                         return_state=collect)
        if collect:
            contrib["ssm_state"] = state
        a = s_out if a is None else (a + s_out) * 0.5
    a = tag("attn.out", a)
    if cfg.post_norms:
        a = _rms(a, lp["post_ln1"])
    x = x + a
    if enc_out is not None and "xattn" in lp:
        xa, (xk, xv) = _cross_attn(lp["xattn"], _rms(x, lp["lnx"]), enc_out,
                                   cfg)
        contrib["xk"], contrib["xv"] = xk, xv
        x = x + xa
    return x, contrib


def _cross_attn(p, x, enc_out, cfg):
    """Cross-attention of x [B, S, D] over the encoder's output enc_out
    [B, F, D], as the reference's ``_cross_attn``: q, k and v by plain
    products (no RoPE, no fused QKV launch, no bias), every frame visible,
    scores in f32 (``chunked_attention``'s default, which the reference
    keeps here whatever ``attn_dtype``).  Returns (y, (k, v) [B, F, KV,
    hd]), the latter what decode caches as ``xk`` / ``xv``."""
    B = x.shape[0]
    KV, hd = cfg.n_kv_heads, cfg.hd
    F_ = enc_out.shape[1]
    k = attn.heads_view(mm(enc_out, p["wk"]), B, F_, KV, hd)
    v = attn.heads_view(mm(enc_out, p["wv"]), B, F_, KV, hd)
    return _cross_attn_cached(p, x, k, v, cfg), (k, v)


def _cross_attn_cached(p, x, xk, xv, cfg):
    """Cross-attention of x [B, S, D] over cached cross K/V ``xk`` /
    ``xv`` [B, F, KV, hd] (read only): the decode step's, and the
    forward's once its k and v are formed."""
    B, S, _ = x.shape
    q = attn.heads_view(mm(x, p["wq"]), B, S, cfg.n_heads, cfg.hd)
    out = attn.chunked_attention(q, xk, xv, causal=False,
                                 chunk_q=cfg.attn_chunk_q)
    return mm(attn.merge_heads(out), p["wo"])


def _sublayer_ffn(lp, x, cfg):
    """The FFN sublayer: (x + its output, the layer's MoE auxiliary loss
    or None where the layer has an MLP); a layer with neither (a pure SSM
    layer) returns x."""
    if "moe" not in lp and "mlp" not in lp:    # a pure SSM layer
        return x, None
    h = _rms(x, lp["ln2"])
    if "moe" in lp:
        apply = (moe_mod.apply_moe_shmap if cfg.moe.impl == "shmap"
                 else moe_mod.apply_moe)
        f, aux = apply(lp["moe"], h, cfg)
        f = tag("mlp.out", f)
        if cfg.post_norms:
            f = _rms(f, lp["post_ln2"])
        return x + f, aux
    wi = lp["mlp"]["wi"]
    inline = None
    if cfg.mlp_inline_threshold is not None:
        inline = ScalarThresholdSparsifier(cfg.mlp_inline_threshold)
    if cfg.gated_mlp:
        # projection, split, act, gate in one decode launch when eligible;
        # None -> the same ops in sequence (the kernel's epilogue replays
        # their roundings: bitwise equal for silu, within a few ulp for
        # gelu, whose tanh is the kernel's own)
        hh = mm_gated(h, wi, cfg.act, inline=inline)
        if hh is None:
            u, v = mm(h, wi, inline=inline).chunk(2, dim=-1)
            hh = act_fn(cfg.act)(u) * v
    else:
        hh = act_fn(cfg.act)(mm(h, wi, inline=inline))
    hh = tag("mlp.act", hh)
    f = tag("mlp.out", mm(hh, lp["mlp"]["wo"]))
    if cfg.post_norms:
        f = _rms(f, lp["post_ln2"])
    return x + f, None


def _remat(fn, remat: str):
    """``fn`` as a layer body under ``remat``: ``"none"`` as it is,
    ``"full"`` recomputed in the backward (non-reentrant checkpoint,
    while gradients are recorded)."""
    if remat not in ("none", "full"):
        raise ValueError(f"remat must be 'none' or 'full', got {remat!r}")
    if remat == "none":
        return fn

    def body(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)

    return body


def _enc_layer(lp, e, cfg):
    e, _ = _sublayer_attn(lp, e, cfg, causal=False)
    return _sublayer_ffn(lp, e, cfg)[0]


def _run_encoder(params, cfg: ModelConfig, enc_embeds, dtype,
                 remat: str = "none"):
    """The encoder stack over the frames ``enc_embeds`` [B, F, D], cast to
    the activation dtype (no embedding scale): every ``enc_layers`` layer
    non-causal, then ``enc_norm`` (the reference's ``_run_encoder``)."""
    e = logical_constraint(enc_embeds.to(dtype), ("batch", "seq", None))
    body = _remat(functools.partial(_enc_layer, cfg=cfg), remat)
    for lp in layer_list(params["enc_layers"]):
        e = body(lp, e)
    return _rms(e, params["enc_norm"])


def _dec_body(lps, x, *, cfg, groups, prefix_len, collect, enc_out):
    """One scan step of the decoder: the layers of ``lps`` (one, or a
    pair's local and global) in order.  Returns (x, the body's summed
    MoE auxiliary loss or None, {group: cache contribution})."""
    aux, cs = None, {}
    for g, lp in zip(groups, lps):
        x, c = _sublayer_attn(lp, x, cfg, is_local=_is_local(cfg, g),
                              prefix_len=prefix_len, collect=collect,
                              enc_out=enc_out)
        x, da = _sublayer_ffn(lp, x, cfg)
        if da is not None:
            aux = da if aux is None else aux + da
        cs[g] = c
    return x, aux, cs


def _need_frames(cfg: ModelConfig, enc_embeds) -> None:
    if cfg.n_enc_layers > 0 and enc_embeds is None:
        raise ValueError(
            f"{cfg.name!r} is an enc-dec model: pass enc_embeds [B, F, "
            f"{cfg.d_model}], the encoder's frame embeddings")


def forward(params, cfg: ModelConfig, tokens=None, *, embeds=None,
            prefix_embeds=None, enc_embeds=None,
            collect_cache: bool = False, with_aux: bool = False,
            remat: str = "none"):
    """tokens [B, S] (or ``embeds`` [B, S, D], taken as they are, in
    place of the scaled token embeddings) -> hidden [B, P + S, D]
    (final-normed).  ``prefix_embeds`` [B, P, D] are cast to the
    activation dtype and prepended, and every layer attends over those P
    positions bidirectionally.  An enc-dec config runs its encoder over
    ``enc_embeds`` [B, F, D] (required: ``ValueError`` without them; a
    config without an encoder ignores them) and every decoder layer
    cross-attends over its output.  With ``collect_cache`` also returns the
    per-layer cache contributions stacked on [L]: (hidden, {"k": [L, B,
    P + S, KV, hd], "v": ...}) (MLA: {"ckv": [L, B, P + S, r], "kr": [L,
    B, P + S, rd]}; enc-dec also {"xk", "xv": [L, B, F, KV, hd]}; an SSM
    or hybrid layer's decode state after the last position,
    {"ssm_state": {"conv": [L, B, W - 1, C], "ssm": [L, B, H, P, N]}}),
    for a pair layout {"local": {...}, "global": {...}} on
    [L/2].  With ``with_aux`` the f32 sum of the layers' MoE
    auxiliary losses (0 without MoE) comes last: (hidden, aux) or
    (hidden, cache, aux).  ``remat``: ``"none"`` or ``"full"`` (each
    layer body recomputed in the backward: the same values and
    gradients)."""
    x = _embed(params, cfg, tokens) if embeds is None else embeds
    prefix_len = 0
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        prefix_len = prefix_embeds.shape[1]
    x = logical_constraint(x, ("batch", "seq", None))
    _need_frames(cfg, enc_embeds)
    enc_out = (_run_encoder(params, cfg, enc_embeds, x.dtype, remat)
               if cfg.n_enc_layers > 0 else None)
    groups = _groups(cfg)
    contribs: dict = {g: {} for g in groups}
    aux = None
    step = _remat(functools.partial(
        _dec_body, cfg=cfg, groups=groups, prefix_len=prefix_len,
        collect=collect_cache, enc_out=enc_out), remat)
    for body in zip(*(layer_list(_group(params["layers"], g))
                      for g in groups)):
        x, da, cs = step(body, x)
        if da is not None:
            aux = da if aux is None else aux + da
        if collect_cache:
            for g, c in cs.items():
                for name, t in c.items():
                    contribs[g].setdefault(name, []).append(t)
    x = _rms(x, params["final_norm"])
    out = (x,)
    if collect_cache:
        cache = {g: {name: _stack(ts) for name, ts in c.items()}
                 for g, c in contribs.items()}
        out += (cache if _pair(cfg) else cache[None],)
    if with_aux:
        out += (torch.zeros((), dtype=torch.float32, device=x.device)
                if aux is None else aux,)
    return out[0] if len(out) == 1 else out


def logits_of(params, cfg: ModelConfig, hidden):
    """The head (tied: ``hidden @ embedding.T``), then ``logit_softcap``
    c as c·tanh(logits/c)."""
    head = params.get("lm_head")
    if head is None:
        logits = hidden @ params["embedding"].T
    else:
        logits = mm(hidden, head)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def loss_fn(params, cfg: ModelConfig, batch, *, aux_weight: float = 0.01,
            remat: str = "none"):
    """Mean next-token cross-entropy: batch {"tokens" [B, S], "labels"
    [B, S], optional "prefix_embeds" [B, P, D] and "enc_embeds" [B, F, D]
    (an enc-dec model's frames)}, labels < 0 masked out;
    the prefix rows of the hidden states are dropped before the head;
    logits in f32.  Returns (ce + aux_weight · moe_aux, {"ce",
    "moe_aux"}), ``moe_aux`` the layers' summed MoE auxiliary loss (0
    without MoE, so the loss is the cross-entropy alone).  ``remat`` as
    in :func:`forward`."""
    prefix = batch.get("prefix_embeds")
    hidden, aux = forward(params, cfg, batch["tokens"], prefix_embeds=prefix,
                          enc_embeds=batch.get("enc_embeds"), with_aux=True,
                          remat=remat)
    if prefix is not None:
        hidden = hidden[:, prefix.shape[1]:]
    labels = batch["labels"].long()
    logits = logits_of(params, cfg, hidden).float()
    logp = torch.log_softmax(logits, dim=-1)
    mask = (labels >= 0).float()
    ll = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    loss = -(ll * mask).sum() / mask.sum().clamp(min=1.0)
    return loss + aux_weight * aux, {"ce": loss, "moe_aux": aux}


def cache_leaves(cache) -> list:
    """Every tensor of a cache tree (flat ``{"k", "v"}`` or a pair
    layout's nested one), in key order."""
    if isinstance(cache, dict):
        return [t for v in cache.values() for t in cache_leaves(v)]
    return [cache]


def map_cache(fn, *caches):
    """The cache tree of ``fn`` over the matching leaves of ``caches``
    (trees of one structure)."""
    if isinstance(caches[0], dict):
        return {k: map_cache(fn, *(c[k] for c in caches))
                for k in caches[0]}
    return fn(*caches)


#: static symmetric scale of an int8 KV cache (the reference's
#: ``KV_QUANT_SCALE``: RoPE'd keys and values are O(1); per-head scales
#: would be the production rule)
KV_QUANT_SCALE = 1.0 / 24.0
#: the f32 reciprocal of the f32 scale.  Codes are ``round(x * 24.0)``:
#: what the reference's jitted programs compute for its ``x /
#: KV_QUANT_SCALE`` (XLA folds the division by a constant into this
#: product; its eager path divides, and its codes differ there, ROADMAP
#: C13), and one rule on the CPU and the card alike
_KV_QUANT_INV = 24.0


def _cache_dt(cfg: ModelConfig) -> torch.dtype:
    """The dtype a K/V or MLA latent leaf is stored in: ``kv_cache_dtype``
    when set, else the model dtype."""
    return (KV_CACHE_DTYPES[cfg.kv_cache_dtype] if cfg.kv_cache_dtype
            else cfg.tdtype)


def _quantize(x: torch.Tensor) -> torch.Tensor:
    """int8 codes of ``x``: ``clamp(round(x * 24), -127, 127)`` in f32
    (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    return torch.clamp(torch.round(x.float() * _KV_QUANT_INV),
                       -127, 127).to(torch.int8)


def _to_cache_dtype(piece: torch.Tensor, dst_dtype) -> torch.Tensor:
    """``piece`` in a cache leaf's dtype ``dst_dtype``: quantized for an
    int8 leaf (codes pass through), a plain cast otherwise.  Every cache
    write of the port goes through here."""
    if dst_dtype == torch.int8 and piece.dtype != torch.int8:
        return _quantize(piece)
    return piece.to(dst_dtype)


def _q_cache(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A K/V or latent tile as the cache stores it (:func:`_cache_dt`)."""
    return _to_cache_dtype(x, _cache_dt(cfg))


@functools.lru_cache(maxsize=None)
def _dq_scale(dtype: torch.dtype) -> float:
    """:data:`KV_QUANT_SCALE` rounded to ``dtype`` (a Python float of that
    exact value: a tensor of ``dtype`` times it rounds as the product of
    two ``dtype`` tensors does)."""
    return torch.tensor(KV_QUANT_SCALE, dtype=dtype).item()


def _dq_cache(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A cache tile read back in the model dtype: int8 codes times the
    scale, both in the model dtype (the reference's rounding before any
    f32 cast); a float leaf as it is stored."""
    if x.dtype == torch.int8:
        return x.to(cfg.tdtype) * _dq_scale(cfg.tdtype)
    return x


def init_cache(cfg: ModelConfig, B: int, S: int, *, enc_len: int = 0,
               local_window_cache: bool = True, device="cuda"):
    """Stacked decode cache {"k", "v"}: [L, B, S, KV, hd] zeros; an MLA
    model's the compressed {"ckv": [L, B, S, r], "kr": [L, B, S, rd]};
    both in :func:`_cache_dt` (int8 codes with ``kv_cache_dtype
    "int8"``); an SSM model's {"ssm_state": {"conv": [L, B, W - 1, C] in
    the model dtype, "ssm": [L, B, H, P, N] in f32}}, a hybrid's both K/V
    and ``ssm_state``.  A pair layout's is {"local": ..., "global": ...},
    each on [L/2], its local leaves a ring of ``min(S, local_window)``
    rows, or full length S with ``local_window_cache=False`` (the paged
    pool's: a page table cannot express a ring); an all-local model's
    K/V leaves are full length S, as the reference's are.  With
    ``enc_len`` an enc-dec model's also holds the cross K/V {"xk", "xv":
    [L, B, enc_len, KV, hd]} in the model dtype (none without it, as in
    the reference)."""
    dev = resolve_device(device)
    cdt = _cache_dt(cfg)

    def layer_cache(L, rows):
        if cfg.attn_type == "mla":
            shapes = {"ckv": (L, B, rows, cfg.mla.kv_lora_rank),
                      "kr": (L, B, rows, cfg.mla.qk_rope_head_dim)}
        elif cfg.attn_type in ("gqa", "hybrid"):
            shape = (L, B, rows, cfg.n_kv_heads, cfg.hd)
            shapes = {"k": shape, "v": shape}
        else:
            shapes = {}
        c: dict[str, Any] = {
            name: torch.zeros(shape, dtype=cdt, device=dev)
            for name, shape in shapes.items()}
        if cfg.attn_type in ("none", "hybrid"):
            c["ssm_state"] = ssm_mod.init_ssm_state(cfg, B, L=L, device=dev)
        if enc_len and cfg.n_enc_layers > 0:
            shape = (L, B, enc_len, cfg.n_kv_heads, cfg.hd)
            c["xk"] = torch.zeros(shape, dtype=cfg.tdtype, device=dev)
            c["xv"] = torch.zeros(shape, dtype=cfg.tdtype, device=dev)
        return c

    if _pair(cfg):
        L = cfg.n_layers // 2
        local = min(S, cfg.local_window) if local_window_cache else S
        return {"local": layer_cache(L, local),
                "global": layer_cache(L, S)}
    return layer_cache(cfg.n_layers, S)


def _decode_gqa_at(p, x, cfg, kc, vc, pv, *, is_local=False):
    """GQA decode of one layer; writes this token's K/V into the layer's
    cache views ``kc``/``vc`` [B, S_c, KV, hd] in place.  A local layer
    whose cache is no longer than its window (a pair layout's ring,
    :func:`init_cache`) writes row ``pv % S_c`` and attends over its
    ``min(pv + 1, S_c)`` rows; any other layer writes at ``pv`` clamped
    onto its last row and attends over ``pv + 1`` rows, a local one (an
    all-local model's full-length cache) over the last ``local_window``
    of them (the reference's rule, ``ring = is_local and S_c <=
    window``).  The token's K/V are stored through :func:`_q_cache`
    and the layer's views read back through :func:`_dq_cache` (int8
    codes dequantized whole, in the model dtype, as the reference's)."""
    B = x.shape[0]
    q, k, v = attn._qkv(p, x, cfg, pv[:, None])
    rows = torch.arange(B, device=x.device)
    S_c = kc.shape[1]
    ring = is_local and S_c <= cfg.local_window
    wpos = (pv % S_c if ring else pv.clamp(max=S_c - 1)).long()
    if is_dtensor(kc):
        _owner_put_(kc, wpos, _q_cache(k[:, 0], cfg))
        _owner_put_(vc, wpos, _q_cache(v[:, 0], cfg))
    else:
        kc.index_put_((rows, wpos), _q_cache(k[:, 0], cfg))
        vc.index_put_((rows, wpos), _q_cache(v[:, 0], cfg))
    n_valid = (pv + 1).clamp(max=S_c) if ring else pv + 1
    window = cfg.local_window if is_local and not ring else None
    out = attn.decode_attention(q, _dq_cache(kc, cfg), _dq_cache(vc, cfg),
                                n_valid, softcap=cfg.attn_softcap,
                                window=window)
    return mm(attn.merge_heads(out), p["wo"])


def _local_rows(t, dst, dim: int):
    """This rank's rows of ``t`` along ``dim`` as ``dst`` (a DTensor)
    holds them, whole along every other dim."""
    from torch.distributed.tensor import Replicate, Shard

    return local_shard(t, dst.device_mesh, tuple(
        Shard(dim) if p.is_shard() and p.dim == dim else Replicate()
        for p in dst.placements))


def _owner_put_(cache, wpos, piece):
    """``cache[b, wpos[b]] = piece[b]`` into a sharded decode cache view
    ``cache`` [B, S_c, ...] (a DTensor, batch and sequence possibly
    sharded), in place: each rank writes the rows it owns, at its offset
    into the sequence, and keeps the others (an in-place indexed write
    cannot cross a sharded dim).  ``wpos`` [B] is replicated."""
    loc = cache.to_local()
    b0, nb = local_range(cache, 0)
    s0, ns = local_range(cache, 1)
    w = wpos[b0:b0 + nb] - s0
    mine = (w >= 0) & (w < ns)
    w = w.clamp(0, ns - 1)
    rows = torch.arange(nb, device=loc.device)
    new = _local_rows(piece, cache, 0).to(loc.dtype)
    keep = loc[rows, w]
    mask = mine.reshape(-1, *([1] * (new.ndim - 1)))
    loc.index_put_((rows, w), torch.where(mask, new, keep))


def _decode_layer(lp, x, cfg, c, pv, *, is_local=False):
    """One layer's decode step over ``c``, the layer's cache views
    ({"k", "v"}, MLA's {"ckv", "kr"}, an SSM's {"ssm_state": {"conv",
    "ssm"}}), every leaf written in place (the SSM state by ``copy_``);
    a hybrid layer mixes attention and SSM as the forward does; an
    enc-dec layer then cross-attends over its ``xk`` / ``xv``, read
    only."""
    h = _rms(x, lp["ln1"])
    a = None
    if cfg.attn_type == "mla":
        a = attn.decode_mla(lp["attn"], h, cfg, c["ckv"], c["kr"], pv,
                            q_cache=_q_cache, dq_cache=_dq_cache)
    elif "attn" in lp:
        a = _decode_gqa_at(lp["attn"], h, cfg, c["k"], c["v"], pv,
                           is_local=is_local)
    if "ssm" in lp:
        st = c["ssm_state"]
        s_out, new = ssm_mod.decode_ssm(lp["ssm"], h, cfg, st)
        st["conv"].copy_(new["conv"])
        st["ssm"].copy_(new["ssm"])
        a = s_out if a is None else (a + s_out) * 0.5
    if cfg.post_norms:
        a = _rms(a, lp["post_ln1"])
    x = x + a
    if "xattn" in lp:
        x = x + _cross_attn_cached(lp["xattn"], _rms(x, lp["lnx"]), c["xk"],
                                   c["xv"], cfg)
    return _sublayer_ffn(lp, x, cfg)[0]


def decode_step(params, cfg: ModelConfig, token, cache, pos):
    """token [B, 1] int; pos [] or [B] (per-slot positions); returns
    (logits [B, V], cache) with the cache updated in place.  An enc-dec
    config needs a cache with cross K/V (``init_cache(enc_len=)``) and
    raises ``ValueError`` over one without: the reference's step runs
    without cross-attention there (a deliberate difference, ROADMAP
    C12)."""
    groups = _groups(cfg)
    if cfg.n_enc_layers > 0 and "xk" not in _group(cache, groups[0]):
        raise ValueError(
            f"decode_step on the enc-dec model {cfg.name!r} over a cache "
            f"without cross K/V: build it with init_cache(..., enc_len=) "
            f"and admit with enc_embeds")
    x = logical_constraint(_embed(params, cfg, token), ("batch", None, None))
    pv = attn.pos_vec(pos, token.shape[0], device=token.device)
    # every leaf, a state leaf too, is stacked on [L] (or [L/2])
    for i in range(cache_leaves(_group(cache, groups[0]))[0].shape[0]):
        for g in groups:
            x = _decode_layer(layer_params(_group(params["layers"], g), i),
                              x, cfg,
                              map_cache(lambda t: t[i], _group(cache, g)),
                              pv, is_local=_is_local(cfg, g))
    x = _rms(x, params["final_norm"])
    return logits_of(params, cfg, x)[:, 0], cache


def _rows(S_src: int, S_c: int, offset, device) -> torch.Tensor:
    """Cache rows of the last ``min(S_src, S_c)`` of ``S_src`` positions
    written from seq offset ``offset``: absolute position p lands at row
    ``p % S_c``, the decode step's ring rule (a full-length leaf gets the
    identity placement)."""
    take = min(S_src, S_c)
    return (torch.arange(take, device=device)
            + (offset + (S_src - take))) % S_c


@functools.lru_cache(maxsize=None)
def _seq_leaf_kinds(cfg: ModelConfig, enc_len: int = 0):
    """Which cache leaves carry a sequence axis (the reference's structural
    rule): ``init_cache(enc_len=)`` probed at two lengths on the meta
    device, a leaf whose shape moves is a sequence leaf (K/V, MLA
    latents, ring leaves too at these small lengths); an SSM's ``conv`` /
    ``ssm`` state leaves and the cross K/V ``xk`` / ``xv`` (sized by
    ``enc_len``) are not.  A tree of bools in the cache's nesting."""
    a, b = (init_cache(cfg, 1, S, enc_len=enc_len, device="meta")
            for S in (2, 3))
    return map_cache(lambda x, y: x.shape != y.shape, a, b)


def _write_slot_leaf(dst, src, slot, offset, is_seq):
    """Write one request's collected cache leaf into batch row ``slot`` of
    ``dst`` [L, B_slots, S_cache, ...] at seq offset ``offset``, in place,
    as one indexed write (rows by :func:`_rows`; a prompt longer than the
    cache keeps its tail).  A state leaf (``is_seq`` false: an SSM's
    ``conv`` / ``ssm``, an enc-dec model's ``xk`` / ``xv``) is
    overwritten whole at ``slot``, and ``offset`` does not touch it.
    ``slot`` and ``offset`` are Python ints or 0-dim integer tensors on
    ``dst``'s device; neither is read back to the host, so a captured
    program writes whichever slot its buffers name at replay.  Stored
    through :func:`_to_cache_dtype` (int8 leaves quantized)."""
    if not is_seq:
        assert dst.shape[2:] == src.shape[2:], (dst.shape, src.shape)
        idx = torch.as_tensor(slot, device=dst.device).reshape(1).long()
        return dst.index_copy_(1, idx, _to_cache_dtype(src, dst.dtype))
    src = src[:, 0]                                     # [L, S_src, ...]
    S_c, S_src = dst.shape[2], src.shape[1]
    rows = _rows(S_src, S_c, offset, dst.device)
    piece = _to_cache_dtype(src[:, S_src - rows.shape[0]:], dst.dtype)
    flat = dst.view(dst.shape[0], -1, *dst.shape[3:])   # [L, B*S_c, ...]
    flat.index_copy_(1, (slot * S_c + rows).long(), piece)
    return dst


def _write_leaf(dst, src, is_seq):
    """Write a batch's collected cache leaf src [L, B, S_src, ...] into a
    fresh ``dst`` [L, B, S_cache, ...] by :func:`_rows` from offset 0; a
    state leaf whole; through :func:`_to_cache_dtype`."""
    if not is_seq:
        return dst.copy_(_to_cache_dtype(src, dst.dtype))
    if is_dtensor(dst):
        return _owner_write_leaf(dst, src)
    rows = _rows(src.shape[2], dst.shape[2], 0, dst.device)
    dst.index_copy_(2, rows, _to_cache_dtype(
        src[:, :, src.shape[2] - rows.shape[0]:], dst.dtype))
    return dst


def _owner_write_leaf(dst, src):
    """:func:`_write_leaf` of a sequence leaf into a sharded cache ``dst``
    (a DTensor [L, B, S_c, ...], batch and sequence possibly sharded):
    each rank writes the rows of its own slice of the sequence, at its
    offset, from ``src`` gathered along the sequence."""
    loc = dst.to_local()
    s0, ns = local_range(dst, 2)
    S_src, S_c = src.shape[2], dst.shape[2]
    rows = _rows(S_src, S_c, 0, torch.device("cpu"))
    take = rows.shape[0]
    sel = ((rows >= s0) & (rows < s0 + ns)).nonzero()[:, 0]
    # every rank gathers (a collective), whether or not it owns a row
    piece = _local_rows(src, dst, 1)[:, :, S_src - take:]
    if sel.numel() == 0:
        return dst
    piece = piece.index_select(2, sel.to(piece.device))
    loc.index_copy_(2, (rows[sel] - s0).to(loc.device),
                    _to_cache_dtype(piece, loc.dtype))
    return dst


def prefill(params, cfg: ModelConfig, tokens, cache_len: int | None = None,
            *, cache=None, slot=None, write_offset=0, prefix_embeds=None,
            enc_embeds=None):
    """Parallel forward that also fills the decode cache; returns
    (last-position logits [B, V], cache).  With ``cache_len`` a fresh
    cache is allocated and positions [0, S) written for the batch; with
    ``cache`` + ``slot`` one request [1, S] is written into batch row
    ``slot`` at seq offset ``write_offset`` (the serving admission path;
    both may be 0-dim device tensors, so one captured program serves every
    slot).  As in the reference, the contributions carry RoPE phases from
    position 0 and the forward reads nothing of the cache: a nonzero
    ``write_offset`` only places rows.

    Both modes place absolute position ``p`` at row ``p % S_cache`` of
    every leaf, the rule the decode step's ring writes follow.  The
    reference's slot mode does so too; its classic mode puts a ring
    leaf's tail at row 0, which is right only for S % S_cache == 0: for
    any other prompt longer than the window the next decode step reads
    misplaced rows (a deliberate difference, ROADMAP C10).

    ``prefix_embeds`` [B, P, D] are prepended as in :func:`forward`, and
    their P rows are written ahead of the prompt's (P + S rows, from
    ``write_offset``); the next decode position is P + S.

    An enc-dec model takes its frames ``enc_embeds`` [B, F, D]; the cross
    K/V of every layer are written whole (a classic cache is built with
    ``enc_len`` F; a slot cache must hold F frames: ``ValueError``
    naming both lengths otherwise), ``write_offset`` does not touch them.

    An SSM's state leaves (the decode state after the last position) are
    written whole in both modes.  A prompt shorter than the conv window's
    ``conv_width - 1`` raises ``ValueError`` in both (ROADMAP C11:
    :func:`~repro_torch.models.ssm.apply_ssm`)."""
    B, S = tokens.shape
    _need_frames(cfg, enc_embeds)
    enc_len = enc_embeds.shape[1] if cfg.n_enc_layers > 0 else 0
    if cache is not None and enc_len:
        xk = _group(cache, _groups(cfg)[0]).get("xk")
        held = 0 if xk is None else xk.shape[2]
        if held != enc_len:
            raise ValueError(
                f"frames of length {enc_len} into a cache whose cross K/V "
                f"hold enc_len {held}")
    hidden, contribs = forward(params, cfg, tokens,
                               prefix_embeds=prefix_embeds,
                               enc_embeds=enc_embeds, collect_cache=True)
    logits = logits_of(params, cfg, hidden[:, -1:])[:, 0]
    kinds = _seq_leaf_kinds(cfg, enc_len)
    if cache is not None:
        assert slot is not None, "slot-mode prefill needs a slot index"
        assert B == 1, "slot-mode prefill admits one request at a time"
        map_cache(lambda d, s, isq: _write_slot_leaf(d, s, slot,
                                                     write_offset, isq),
                  cache, contribs, kinds)
        return logits, cache
    assert cache_len is not None, "prefill needs cache_len or cache+slot"
    cache = init_cache(cfg, B, cache_len, enc_len=enc_len,
                       device=tokens.device)
    map_cache(_write_leaf, cache, contribs, kinds)
    return logits, cache


def prefill_into_slot(params, cfg: ModelConfig, tokens, cache, slot, *,
                      write_offset=0, prefix_embeds=None, enc_embeds=None):
    """Admit one request: prefill ``tokens`` [1, S] (behind
    ``prefix_embeds`` [1, P, D], if given; an enc-dec model over its
    frames ``enc_embeds`` [1, F, D]) into batch row ``slot`` of ``cache``
    at seq offset ``write_offset`` (ints or 0-dim device tensors);
    returns (last-position logits [1, V], cache)."""
    return prefill(params, cfg, tokens, cache=cache, slot=slot,
                   write_offset=write_offset, prefix_embeds=prefix_embeds,
                   enc_embeds=enc_embeds)
