"""Parity of the port's n:m:g layout and conversion with the JAX package:
pattern tables and gather plans equal element for element, bridged
storage densifies to the reference's matrix, and the port's greedy
conversion picks the reference's permutation wherever the score sums are
exact."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layouts as jl
from repro.core import nmg as jnmg
from repro_torch import bridge
from repro_torch.core import layouts as tl
from repro_torch.core import nmg as tnmg
from repro_torch.core.builder import SparsityBuilder
from repro_torch.core.sparsifiers import GroupedNMSparsifier

from tests._torch_compat import jax_dense_to_grouped_nm, nmg_to_numpy

NM = [(1, 4), (2, 4), (3, 6), (1, 2), (2, 6), (4, 4)]
# (n, m, g, gr, R, K, sparse_dim): padded K and R, both sparse dims, the
# serving format 1:4:8 with row sharing
FORMATS = [
    (1, 4, 8, 16, 48, 64, 0),
    (2, 4, 2, 4, 10, 100, -1),
    (3, 6, 1, 2, 8, 120, -1),
]
FMT_IDS = ["{}:{}:{}gr{}_{}x{}_sd{}".format(*f) for f in FORMATS]


@pytest.mark.parametrize("nm", NM, ids=lambda p: "{}:{}".format(*p))
def test_pattern_tables_equal_reference(nm):
    n, m = nm
    np.testing.assert_array_equal(tl.nm_patterns(n, m), jl.nm_patterns(n, m))
    np.testing.assert_array_equal(tl.pattern_onehots(n, m),
                                  jl.pattern_onehots(n, m))
    for g in (1, 3, 8):
        np.testing.assert_array_equal(tl.pos_pattern_offsets(n, m, g),
                                      jl.pos_pattern_offsets(n, m, g))


@functools.lru_cache(maxsize=None)
def _ref(fmt, seed=0, dtype=np.float32):
    n, m, g, gr, R, K, sd = fmt
    x = np.random.default_rng(seed).standard_normal((R, K)).astype(dtype)
    return x, jax_dense_to_grouped_nm(jnp.asarray(x), n=n, m=m, g=g, gr=gr,
                                      sparse_dim=sd)


@pytest.mark.parametrize("fmt", FORMATS, ids=FMT_IDS)
def test_spmm_plan_equals_reference(fmt):
    n, m, g = fmt[:3]
    _, t = _ref(fmt)
    blk = torch.from_numpy(np.asarray(t.blk_idx).copy())
    plan = tl.build_spmm_plan(blk, n, m, g)
    ref = jl.build_spmm_plan(t.blk_idx, n, m, g)
    assert plan.cols.dtype == torch.int32
    np.testing.assert_array_equal(plan.cols.numpy(), np.asarray(ref.cols))
    np.testing.assert_array_equal(plan.pat_onehot.numpy(),
                                  np.asarray(ref.pat_onehot))


@pytest.mark.parametrize("fmt", FORMATS, ids=FMT_IDS)
def test_bridged_to_dense_equals_reference(fmt):
    """Densifying is a scatter of stored values: exact in f32."""
    _, t = _ref(fmt)
    port = bridge.params_from_numpy(nmg_to_numpy(t), device="cpu")
    np.testing.assert_array_equal(port.to_dense().numpy(),
                                  np.asarray(t.to_dense()))


@pytest.mark.parametrize("fmt", FORMATS, ids=FMT_IDS)
def test_greedy_blk_idx_equals_reference_on_integers(fmt):
    """Small-integer inputs make every score sum exact in both packages,
    so argmax ties resolve the same way (first index) and the greedy
    permutation, values and plan must match exactly."""
    n, m, g, gr, R, K, sd = fmt
    x = np.random.default_rng(1).integers(-9, 10, (R, K)).astype(np.float32)
    ref = jax_dense_to_grouped_nm(jnp.asarray(x), n=n, m=m, g=g, gr=gr,
                                  sparse_dim=sd)
    got = tnmg.dense_to_grouped_nm(torch.from_numpy(x), n=n, m=m, g=g, gr=gr,
                                   sparse_dim=sd)
    np.testing.assert_array_equal(got.blk_idx.numpy(), np.asarray(ref.blk_idx))
    np.testing.assert_array_equal(got.val.numpy(), np.asarray(ref.val))
    np.testing.assert_array_equal(got.plan.cols.numpy(),
                                  np.asarray(ref.plan.cols))
    assert got.dense_shape == tuple(ref.dense_shape)
    assert got.sparse_dim == ref.sparse_dim


@pytest.mark.parametrize("fmt", FORMATS, ids=FMT_IDS)
def test_greedy_energy_matches_reference_on_random(fmt):
    """Random inputs: near ties may flip under another summation order, so
    compare preserved energy (relative 1e-4: a flipped tie moves it by a
    tie-sized amount) and check the port's tensor keeps exactly the values
    it claims to keep."""
    x, ref = _ref(fmt, seed=2)
    n, m, g, gr, R, K, sd = fmt
    xt = torch.from_numpy(x)
    got = tnmg.dense_to_grouped_nm(xt, n=n, m=m, g=g, gr=gr, sparse_dim=sd)
    dense = got.to_dense()
    e_ref = float(jnmg.energy(ref.to_dense(), jnp.asarray(x)))
    e_got = float(tnmg.energy(dense, xt))
    assert e_got == pytest.approx(e_ref, rel=1e-4)
    kept = dense != 0
    np.testing.assert_array_equal(dense[kept].numpy(), x[kept.numpy()])


def test_builder_stacks_per_layer_conversions():
    """A scan-stacked [L, K, N] weight converts per layer and re-stacks;
    ``layer(i)`` slices back exactly the per-layer conversion."""
    w = torch.from_numpy(np.random.default_rng(3).integers(
        -9, 10, (3, 64, 32)).astype(np.float32))
    sp = GroupedNMSparsifier(1, 4, 8, 16, sparse_dim=0)
    out = SparsityBuilder().set_weight(
        "*mlp.wi", sp, tl.GroupedNMTensor).sparsify_params(
        {"layers": {"mlp": {"wi": w, "wo": w}}})
    st = out["layers"]["mlp"]["wi"]
    assert isinstance(st, tl.GroupedNMTensor) and st.stacked
    assert isinstance(out["layers"]["mlp"]["wo"], torch.Tensor)
    for i in range(3):
        one = tnmg.dense_to_grouped_nm(w[i], 1, 4, 8, gr=16, sparse_dim=0)
        li = st.layer(i)
        assert torch.equal(li.val, one.val)
        assert torch.equal(li.blk_idx, one.blk_idx)
        assert torch.equal(li.plan.cols, one.plan.cols)
        assert li.val.is_contiguous() and li.plan.cols.is_contiguous()


def test_builder_default_is_fixed_mask_as_reference():
    """A GroupedNMSparsifier rule with no output format makes a
    FixedMaskTensor whose mask is what the n:m:g conversion keeps, per
    layer, with the sparsifier as its origin: the reference's result on
    the same (integer, so exactly scored) weights, mask and values
    equal."""
    from repro.core.builder import SparsityBuilder as JaxBuilder
    from repro.core.sparsifiers import GroupedNMSparsifier as JaxGNM

    w = np.random.default_rng(5).integers(-9, 10, (3, 64, 32)).astype(
        np.float32)
    ref = JaxBuilder().set_weight("*mlp.wi", JaxGNM(
        1, 4, 8, 16, sparse_dim=0)).sparsify_params(
        {"layers": {"mlp": {"wi": jnp.asarray(w)}}})["layers"]["mlp"]["wi"]
    sp = GroupedNMSparsifier(1, 4, 8, 16, sparse_dim=0)
    got = SparsityBuilder().set_weight("*mlp.wi", sp).sparsify_params(
        {"layers": {"mlp": {"wi": torch.from_numpy(w)}}})["layers"]["mlp"]
    got = got["wi"]
    assert isinstance(got, tl.FixedMaskTensor) and got.origin == sp
    assert type(ref).__name__ == "FixedMaskTensor"
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.val.numpy(), np.asarray(ref.val))


def test_bridge_bf16_keeps_bits():
    x = np.asarray(jnp.asarray(np.random.default_rng(4).standard_normal(
        (5, 7)), jnp.bfloat16))
    x.setflags(write=False)      # arrays from JAX are read-only
    t = bridge.tensor_from_numpy(x, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  x.view(np.int16))
