"""Model configuration and the sparse-aware weight apply (port of
``repro/models/common.py``).

``ModelConfig`` is a copy of the reference's dataclass, field for field.
``MLAConfig``, ``MoEConfig`` and ``SSMConfig`` are the reference's too.
The port runs its decoder subset: GQA or MLA (multi-head latent)
attention, a Mamba2 SSD mixer alone (``attn_type "none"``) or beside GQA
attention (``"hybrid"``, hymba; ``models/ssm.py``), plain or gated MLP or
a mixture of experts (``models/moe.py``: the ``pjit`` and the
expert-parallel ``shmap`` implementations, with the ``gather``,
``replicated`` or ``scatter`` combine), with or
without QKV bias and the MLP's inline threshold, global layers, all-local
layers or alternating local/global layer pairs with a sliding window,
attention and logit softcaps, post-norms, a tied or separate head, and a
prefix of precomputed embeddings under a prefix-LM mask (the VLM stub
frontend), and an encoder over precomputed frame embeddings with
cross-attention in every decoder layer (enc-dec, whisper's shape: GQA,
global layers), with a KV cache in the model dtype or in any of
:data:`KV_CACHE_DTYPES` (int8 among them).
:meth:`ModelConfig.check_ported` raises ``NotImplementedError`` for the
other families (enc-dec beside anything but whisper's shape, a KV cache
dtype outside :data:`KV_CACHE_DTYPES`) and for a MoE ``impl`` or
``combine`` the reference does not have.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.layouts import DenseTensor, GroupedNMTensor, \
    SparsityLayout

__all__ = ["MLAConfig", "MoEConfig", "ModelConfig", "SSMConfig", "mm", "mm_fused_qkv",
           "mm_gated", "torch_dtype", "KV_CACHE_DTYPES"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

#: the ``kv_cache_dtype`` names the port stores a KV cache in: int8
#: (quantized, ``models/transformer.py:_q_cache``) and the float names of
#: the reference's ``_cache_dt`` that torch has (a plain cast)
KV_CACHE_DTYPES = {"int8": torch.int8, **_DTYPES}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def mm(x: torch.Tensor, w, *, inline=None) -> torch.Tensor:
    """Weight application admitting sparse layouts: a dense weight is a
    plain product; a ``GroupedNMTensor`` (serving) goes straight to the
    shape-routed n:m:g kernels (``kernels/ops.py:nmg_linear``, what its
    ``dispatch("linear")`` registration calls, without the per-call
    registry lookup on the host-bound decode path); any other layout
    (``FixedMaskTensor`` in masked training) goes through
    ``dispatch("linear")``, and a dense weight with an ``inline``
    sparsifier through ``dispatch("matmul")`` on ``DenseTensor``
    operands, where a ``ScalarThresholdSparsifier`` reaches the fused
    ``matmul_threshold`` kernel.  A layout result comes back masked-dense,
    cast to the dtype ``x @ w`` would promote to, so sparsifying a weight
    never changes a layer's output dtype."""
    if not isinstance(w, SparsityLayout) and inline is None:
        return x @ w
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if isinstance(w, GroupedNMTensor) and inline is None:
        from repro_torch.kernels import ops as kops

        y = kops.nmg_linear(x, w)
        return y if y.dtype == out_dtype else y.to(out_dtype)
    from repro_torch.core import ops as sten_ops

    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, SparsityLayout):
        y = sten_ops.linear(x2, w, inline=inline)
    else:
        y = sten_ops.matmul(DenseTensor(x2), DenseTensor(w), inline=inline)
    if isinstance(y, SparsityLayout):
        y = y.to_dense()
    if y.dtype != out_dtype:
        y = y.to(out_dtype)
    return y.reshape(*lead, -1)


def mm_fused_qkv(x: torch.Tensor, wq, wk, wv) -> tuple:
    """The attention projections through the fused QKV launch when
    eligible, else three :func:`mm` calls."""
    from repro_torch.kernels import ops as kops

    ws = (wq, wk, wv)
    ys = kops.maybe_fused_qkv(x, ws)
    if ys is None:
        return tuple(mm(x, w) for w in ws)
    outs = []
    for y, w in zip(ys, ws):
        out_dtype = torch.promote_types(x.dtype, w.dtype)
        outs.append(y if y.dtype == out_dtype else y.to(out_dtype))
    return tuple(outs)


def mm_gated(x: torch.Tensor, w, act: str, *, inline=None):
    """The gated-MLP pair (packed [D, 2F] weight) with the activation fused
    into the projection kernel's epilogue, or None when that route is
    ineligible: the caller then runs projection, split and activation.
    Declines when a promotion cast would sit between projection and gate
    (it would move the activation's rounding, and fused must equal
    sequential bitwise)."""
    if inline is not None:
        return None
    if torch.promote_types(x.dtype, getattr(w, "dtype", x.dtype)) != x.dtype:
        return None
    from repro_torch.kernels import ops as kops

    return kops.maybe_fused_ffn(x, w, act=act)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_expert: int = 1024          # expert FFN hidden size
    capacity_factor: float = 1.25
    dense_residual: bool = False  # Arctic-style dense MLP in parallel
    dense_residual_ff: int = 0
    router_jitter: float = 0.0
    combine: str = "gather"   # gather | scatter (EP combine strategy)
    impl: str = "pjit"        # pjit | shmap (explicit shard_map EP)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    acc_dtype: str = "float32"   # SSD intra-chunk product dtype

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    vocab: int = 32000
    d_model: int = 1024
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 4096
    attn_type: str = "gqa"        # gqa | mla | none | hybrid
    qkv_bias: bool = False
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    local_window: Optional[int] = None
    layer_pattern: str = "global"  # global | local | alt_local_global
    post_norms: bool = False
    act: str = "silu"              # silu | gelu
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    n_enc_layers: int = 0
    vision_prefix: int = 0
    attn_chunk_q: int = 512
    attn_chunk_k: int = 512
    attn_dtype: str = "float32"
    kv_cache_dtype: Optional[str] = None
    dtype: str = "bfloat16"
    sparse_targets: tuple = ("mlp.wi", "mlp.wo", "attn.wo")
    mlp_inline_threshold: Optional[float] = None

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def validate(self):
        assert self.n_heads % max(1, self.n_kv_heads) == 0
        return self.check_ported()

    def check_ported(self):
        """Raise NotImplementedError unless this config lies in the
        ported subset: a decoder with GQA attention or MLA (``attn_type
        "mla"`` with an ``MLAConfig``), plain or gated MLP or a
        ``MoEConfig`` mixture of experts (``impl="pjit"`` with the
        ``gather`` or ``replicated`` combine, which on one device are the
        same computation), a Mamba2 mixer alone or beside GQA attention
        (``attn_type "none"`` / ``"hybrid"`` with an ``SSMConfig``),
        optional QKV bias and MLP inline threshold, global layers,
        all-local layers (``local`` with ``local_window``) or
        local/global pairs (``alt_local_global`` with ``local_window``,
        an even layer count), softcaps, post-norms, a VLM prefix
        (``vision_prefix`` precomputed embeddings), an encoder stack with
        cross-attention (``n_enc_layers > 0``) on whisper's shape alone
        (GQA attention, global layers, no MoE, SSM or prefix; any other
        enc-dec combination is refused by a name that says ``enc-dec``);
        a KV cache stored in the model dtype, in int8 (``kv_cache_dtype
        "int8"``, the reference's static-scale quantizer) or in one of
        :data:`KV_CACHE_DTYPES` (any other name is refused by a message
        that names it).  Every MoE strategy of the reference is ported:
        ``impl="pjit"`` or ``"shmap"`` (expert parallelism over the
        "model" axis of an active mesh, and ``apply_moe`` without one)
        with the ``gather``, ``replicated`` or ``scatter`` combine."""
        moe, encdec = self.moe, self.n_enc_layers > 0
        unported = {
            "attn_type not in ('gqa', 'mla', 'none', 'hybrid')":
                self.attn_type not in ("gqa", "mla", "none", "hybrid"),
            "mla without an MLAConfig":
                self.attn_type == "mla" and self.mla is None,
            "moe without a MoEConfig":
                moe is not None and not isinstance(moe, MoEConfig),
            f"moe impl {getattr(moe, 'impl', None)!r}":
                isinstance(moe, MoEConfig)
                and moe.impl not in ("pjit", "shmap"),
            f"moe combine {getattr(moe, 'combine', None)!r}":
                isinstance(moe, MoEConfig)
                and moe.combine not in ("gather", "replicated", "scatter"),
            "ssm without an SSMConfig":
                self.ssm is not None and not isinstance(self.ssm, SSMConfig),
            "attn_type 'none' / 'hybrid' without an SSMConfig":
                self.attn_type in ("none", "hybrid")
                and not isinstance(self.ssm, SSMConfig),
            "layer_pattern 'local' without local_window":
                self.layer_pattern == "local" and self.local_window is None,
            "local/global pairs without local_window or of odd depth":
                self.layer_pattern == "alt_local_global"
                and (self.local_window is None or self.n_layers % 2),
            f"enc-dec with attn_type {self.attn_type!r}":
                encdec and self.attn_type != "gqa",
            f"enc-dec with layer_pattern {self.layer_pattern!r}":
                encdec and self.layer_pattern != "global",
            "enc-dec with a MoE": encdec and moe is not None,
            "enc-dec with an SSM": encdec and self.ssm is not None,
            "enc-dec with a vision prefix":
                encdec and self.vision_prefix > 0,
            f"kv_cache_dtype {self.kv_cache_dtype!r} (the port stores "
            f"the KV cache in one of {sorted(KV_CACHE_DTYPES)})":
                self.kv_cache_dtype is not None
                and self.kv_cache_dtype not in KV_CACHE_DTYPES,
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"config {self.name!r} uses features the port does not "
                f"run yet: {', '.join(bad)}")
        return self

    def scaled(self, **kw) -> "ModelConfig":
        """A reduced copy for CPU smoke tests."""
        return dataclasses.replace(self, **kw)
