"""Helpers shared by the ``tests/test_torch_*.py`` parity tests: carry
the JAX package's arrays and params into numpy in the shape the port's
bridge (``repro_torch.bridge``) takes, and skip CUDA-only tests on hosts
without a card (decided inside the test, never at import)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core import nmg as jax_nmg
from repro.core import layouts as jl
from repro.core.layouts import FixedMaskTensor as JaxFixedMask
from repro.core.layouts import GroupedNMTensor as JaxGroupedNM
from repro.models import init_lm as jax_init_lm
from repro.serve.engine import sparsify_for_serving as jax_sparsify


def nmg_to_numpy(t) -> dict:
    """A JAX GroupedNMTensor as the bridge's sparse-leaf dict."""
    return {"val": np.asarray(t.val), "blk_idx": np.asarray(t.blk_idx),
            "cols": np.asarray(t.gather_plan().cols), "n": t.n, "m": t.m,
            "g": t.g, "gr": t.gr, "dense_shape": tuple(t.dense_shape),
            "sparse_dim": t.sparse_dim}


def sparsifier_to_dict(sp):
    """A JAX sparsifier as the bridge's ``{"type": class name, **fields}``
    (None stays None)."""
    if sp is None:
        return None
    return {"type": type(sp).__name__, **dataclasses.asdict(sp)}


def params_to_numpy(tree):
    """A JAX params tree as nested dicts of numpy arrays; a layout leaf as
    the dict of its fields that ``repro_torch.bridge`` reads (a
    FixedMaskTensor as ``{"val", "mask", "origin"}``, ...)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, JaxGroupedNM):
        return nmg_to_numpy(tree)
    if isinstance(tree, JaxFixedMask):
        return {"val": np.asarray(tree.val), "mask": np.asarray(tree.mask),
                "origin": sparsifier_to_dict(tree.origin)}
    if isinstance(tree, jl.NMTensor):
        return {"val": np.asarray(tree.val), "idx": np.asarray(tree.idx),
                "n": tree.n, "m": tree.m, "dense_shape": tree.dense_shape}
    if isinstance(tree, jl.CsrTensor):
        return {"data": np.asarray(tree.data),
                "indices": np.asarray(tree.indices),
                "indptr": np.asarray(tree.indptr),
                "dense_shape": tree.dense_shape}
    if isinstance(tree, jl.CooTensor):
        return {"data": np.asarray(tree.data),
                "coords": np.asarray(tree.coords),
                "dense_shape": tree.dense_shape}
    if isinstance(tree, jl.DenseTensor):
        return {"data": np.asarray(tree.data)}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def smoke_setup(sparse: bool, arch: str = "bert-base-sten",
                bias_seed=None):
    """The SMOKE config of ``arch`` in f32 for both packages, the
    reference's params from ``init_lm(PRNGKey(0))`` (n:m:g 1:4:8 gr16
    with ``attn=True`` when ``sparse``; init and conversion each run under
    one ``jax.jit``), and their bridged port twins:
    (jax cfg, port cfg, jax params, port params).  With ``bias_seed`` the
    QKV biases, zero after init in both packages, are set to seeded
    normal values first, so the bias add is exercised."""
    from repro_torch import bridge
    from repro_torch.configs import get_smoke

    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    jp = jax.jit(jax_init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    if bias_seed is not None:
        rng = np.random.default_rng(bias_seed)
        attn = dict(jp["layers"]["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jax.numpy.asarray(
                rng.standard_normal(attn[name].shape), attn[name].dtype)
        jp = {**jp, "layers": {**jp["layers"], "attn": attn}}
    if sparse:
        jp = jax.jit(lambda p: jax_sparsify(p, 1, 4, 8, gr=16, attn=True))(jp)
    return jcfg, tcfg, jp, bridge.params_from_numpy(params_to_numpy(jp),
                                                    device="cpu")


#: the reference's n:m:g conversion under one jit per shape and format
#: (eager, its greedy fori_loop recompiles on every call)
jax_dense_to_grouped_nm = jax.jit(
    jax_nmg.dense_to_grouped_nm,
    static_argnames=("n", "m", "g", "gr", "sparse_dim", "method"))


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false); runs on the card")
