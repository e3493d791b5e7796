"""The port's model stack against the JAX package's on the bert-base-sten
SMOKE config in f32, with the reference's weights (dense, and n:m:g 1:4:8
gr16 with ``attn=True``) carried over by the bridge: forward hidden
states, prefill logits and several decode steps allclose, greedy tokens
equal.  Plus the port's guards: no JAX/``repro`` imports, no silent CPU
runs, unported families raise."""

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


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_prefill_and_decode_match_reference(sparse):
    """Prompt of 20 tokens (the SpMM route), then four single-token decode
    steps (GEMV, fused QKV): logits and the filled KV cache allclose,
    greedy tokens equal."""
    jcfg, tcfg, jp, tp = smoke_setup(sparse)
    if sparse:
        assert isinstance(tp["layers"]["attn"]["wq"], GroupedNMTensor)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (1, 20),
                                             dtype=np.int32)

    cache_len = 20 + 5
    j_pre = jax.jit(j_prefill, static_argnums=(1, 3))
    j_dec = jax.jit(j_decode, static_argnums=(1,))
    jl, jc = j_pre(jp, jcfg, jnp.asarray(toks), cache_len)
    tops.reset_kernel_counters()
    tl, tc = prefill(tp, tcfg, torch.from_numpy(toks), cache_len=cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    if sparse:
        assert tops.kernel_counters()[("nmg_linear", "spmm[default]")] > 0
    tok = int(np.argmax(np.asarray(jl)[0]))
    assert tok == int(torch.argmax(tl[0]))
    tops.reset_kernel_counters()
    for i in range(4):
        t_in = np.array([[tok]], np.int32)
        jl, jc = j_dec(jp, jcfg, jnp.asarray(t_in), jc,
                       jnp.asarray(20 + i))
        tl, tc = decode_step(tp, tcfg, torch.from_numpy(t_in), tc,
                             torch.tensor(20 + i))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = int(np.argmax(np.asarray(jl)[0]))
        assert tok == int(torch.argmax(tl[0]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    if sparse:
        c = tops.kernel_counters()
        assert c[("nmg_qkv", "fused[default]")] == 4 * tcfg.n_layers
        assert ("nmg_linear", "spmm[default]") not in c


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
    gated = dataclasses.replace(get_smoke("bert-base-sten"), gated_mlp=True)
    with pytest.raises(NotImplementedError, match="gated_mlp"):
        init_lm(gated, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("qwen1.5-4b")
    full = get_config("bert-base-sten")
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab, full.dtype) \
        == (12, 768, 3072, 30522, "bfloat16")
