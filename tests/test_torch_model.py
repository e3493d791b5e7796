"""The port's model stack against the JAX package's on the SMOKE configs
of bert-base-sten (plain MLP) and qwen1.5-4b (gated MLP, QKV bias) in f32,
with the reference's weights (dense, and n:m:g 1:4:8 gr16 with
``attn=True``) carried over by the bridge: forward hidden states, prefill
logits and several decode steps allclose, greedy tokens equal.  Plus the
port's guards: no JAX/``repro`` imports, no silent CPU runs, unported
families raise (starcoder2-15b and gemma2-9b: ``test_torch_families.py``)."""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as j_decode, prefill as j_prefill
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels import ops as tops
from repro_torch.models import decode_step, forward, init_cache, init_lm, \
    prefill
from repro_torch.serve import ServeEngine, sparsify_for_serving

from tests._torch_compat import smoke_setup

ROOT = Path(__file__).resolve().parents[1]
# f32 end to end in both packages; outputs differ by summation order only
# (einsum/matmul blocking, online vs exact softmax), ~1e-6 relative per
# layer on O(1) activations, so 1e-4 leaves two orders of margin
TOL = dict(rtol=1e-4, atol=1e-4)


def _prefill_and_decode(setup):
    """Prompt of 20 tokens (the SpMM route), then four single-token decode
    steps (GEMV, fused QKV, fused FFN): logits and the filled KV cache
    allclose, greedy tokens equal.  Returns the port's kernel counters of
    the prefill and of each decode step."""
    jcfg, tcfg, jp, tp = setup
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (1, 20),
                                             dtype=np.int32)

    cache_len = 20 + 5
    j_pre = jax.jit(j_prefill, static_argnums=(1, 3))
    j_dec = jax.jit(j_decode, static_argnums=(1,))
    jl, jc = j_pre(jp, jcfg, jnp.asarray(toks), cache_len)
    tops.reset_kernel_counters()
    tl, tc = prefill(tp, tcfg, torch.from_numpy(toks), cache_len=cache_len)
    counts = [tops.kernel_counters()]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok = int(np.argmax(np.asarray(jl)[0]))
    assert tok == int(torch.argmax(tl[0]))
    for i in range(4):
        t_in = np.array([[tok]], np.int32)
        jl, jc = j_dec(jp, jcfg, jnp.asarray(t_in), jc,
                       jnp.asarray(20 + i))
        tops.reset_kernel_counters()
        tl, tc = decode_step(tp, tcfg, torch.from_numpy(t_in), tc,
                             torch.tensor(20 + i))
        counts.append(tops.kernel_counters())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = int(np.argmax(np.asarray(jl)[0]))
        assert tok == int(torch.argmax(tl[0]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)
    return counts


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_prefill_and_decode_match_reference(sparse):
    setup = smoke_setup(sparse)
    if sparse:
        assert isinstance(setup[3]["layers"]["attn"]["wq"], GroupedNMTensor)
    pre, *steps = _prefill_and_decode(setup)
    if sparse:
        assert pre[("nmg_linear", "spmm[default]")] > 0
        for c in steps:
            assert c[("nmg_qkv", "fused[default]")] == setup[1].n_layers
            assert ("nmg_linear", "spmm[default]") not in c


@pytest.mark.parametrize("bias", [False, True], ids=["zero-bias", "bias"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_qwen_prefill_and_decode_match_reference(sparse, bias):
    """qwen1.5-4b SMOKE: the gated MLP (packed [D, 2F] wi) and the QKV
    bias, with biases left at zero and set to seeded nonzero values.  In
    the n:m:g model every decode step runs each layer's FFN through the
    fused launch once; the 20-token prefill runs the packed wi through
    the SpMM and gates it in sequence."""
    setup = smoke_setup(sparse, "qwen1.5-4b", 3 if bias else None)
    tcfg, tp = setup[1], setup[3]
    assert tcfg.gated_mlp and tcfg.qkv_bias
    assert tp["layers"]["mlp"]["wi"].shape[-1] == 2 * tcfg.d_ff
    assert bool((tp["layers"]["attn"]["bq"] != 0).any()) == bias
    pre, *steps = _prefill_and_decode(setup)
    L = tcfg.n_layers
    if not sparse:
        assert not any(k[0] == "nmg_ffn" for c in steps for k in c)
        return
    assert ("nmg_ffn", "fused[default]") not in pre
    assert pre[("nmg_linear", "spmm[default]")] > 0
    for c in steps:
        assert c[("nmg_ffn", "fused[default]")] == L
        assert c[("nmg_ffn", "plain")] == L
        assert c[("nmg_qkv", "fused[default]")] == L


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_bridge_carries_qkv_bias_and_packed_wi(sparse):
    """The bias leaves and the packed gated wi (dense or n:m:g) cross the
    bridge unchanged."""
    _, tcfg, jp, tp = smoke_setup(sparse, "qwen1.5-4b", 3)
    for name in ("bq", "bk", "bv"):
        np.testing.assert_array_equal(
            tp["layers"]["attn"][name].numpy(),
            np.asarray(jp["layers"]["attn"][name]))
    jwi, twi = jp["layers"]["mlp"]["wi"], tp["layers"]["mlp"]["wi"]
    if not sparse:
        assert tuple(twi.shape) == (tcfg.n_layers, tcfg.d_model,
                                    2 * tcfg.d_ff)
        np.testing.assert_array_equal(twi.numpy(), np.asarray(jwi))
        return
    assert twi.dense_shape == (tcfg.d_model, 2 * tcfg.d_ff)
    np.testing.assert_array_equal(twi.val.numpy(), np.asarray(jwi.val))
    np.testing.assert_array_equal(twi.blk_idx.numpy(),
                                  np.asarray(jwi.blk_idx))
    assert tops.fusable_ffn(twi.layer(0), tcfg.d_ff)


def test_sparse_model_equals_its_densified_twin():
    """The port's own pipeline: init, sparsify (its own greedy
    conversion), then the n:m:g model equals the dense model whose weights
    are the densified n:m:g tensors."""
    cfg = dataclasses.replace(get_smoke("bert-base-sten"), dtype="float32")
    params = init_lm(cfg, seed=3, device="cpu")
    sp = sparsify_for_serving(params, 1, 4, 8, gr=16, attn=True)

    def densify(tree):
        if isinstance(tree, dict):
            return {k: densify(v) for k, v in tree.items()}
        if isinstance(tree, GroupedNMTensor):
            L = tree.val.shape[0]
            return torch.stack([tree.layer(i).to_dense() for i in range(L)])
        return tree

    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 9), dtype=np.int64))
    a = forward(sp, cfg, toks)
    b = forward(densify(sp), cfg, toks)
    assert a.shape == (2, 9, cfg.d_model) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, **TOL)


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_repro():
    offenders = []
    files = _port_files()
    assert len(files) > 20 and files[-1].exists()
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro", "ml_dtypes"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert not offenders, offenders


def test_entry_points_raise_without_cuda():
    """Asked for the card (the default) on a host without one, every
    public entry point raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = get_smoke("bert-base-sten")
    with pytest.raises(RuntimeError, match="cuda"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_lm(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.params_from_numpy({"w": np.zeros(3, np.float32)})
    params = init_lm(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(params, cfg)
    from repro_torch.launch import serve as launch

    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--engine", "--smoke"])


def test_unported_families_raise():
    # int8 and the float names are ported (tests/test_torch_kvcache.py);
    # any other cache dtype is refused by name
    int4 = dataclasses.replace(get_smoke("qwen1.5-4b"), kv_cache_dtype="int4")
    with pytest.raises(NotImplementedError, match="kv_cache_dtype 'int4'"):
        init_lm(int4, device="cpu")
    # whisper (enc-dec) is ported: its config is the reference's
    from repro.configs import get_arch as j_config

    wh = get_config("whisper-large-v3")
    assert dataclasses.asdict(wh) == dataclasses.asdict(
        j_config("whisper-large-v3"))
    assert (wh.n_layers, wh.n_enc_layers, wh.d_model, wh.d_ff, wh.vocab,
            wh.n_heads, wh.n_kv_heads, wh.hd, wh.act, wh.gated_mlp) \
        == (32, 32, 1280, 5120, 51866, 20, 20, 64, "gelu", False)
    assert wh.check_ported() is wh
    full = get_config("bert-base-sten")
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab, full.dtype) \
        == (12, 768, 3072, 30522, "bfloat16")
    qwen = get_config("qwen1.5-4b")
    assert (qwen.n_layers, qwen.d_model, qwen.d_ff, qwen.vocab, qwen.dtype,
            qwen.gated_mlp, qwen.qkv_bias, qwen.rope_theta) \
        == (40, 2560, 6912, 151936, "bfloat16", True, True, 1e6)
