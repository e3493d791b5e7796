"""The port's layouts, sparsifiers, gradient plumbing and the
``repro_torch.sten`` namespace against the JAX package's, on the same
numpy inputs: layout round trips, capacities and stored fields, every
registered layout's differential invariants (round trip, structure,
gradients), the sparsifier taxonomy and masks, every
``SameFormatSparsifier`` branch, ``sparsify_grads``, and the reference's
``examples/quickstart.py`` and ``examples/custom_layout.py`` run through
``repro_torch.sten``.

Tolerances, each with its reason:
- stored fields (CSR/COO data, indices, indptr, coords; n:m values and
  offsets; n:m:g indices), masks and densified values: exact (the same
  selections of the same f32 values; n:m:g inputs are small integers, so
  every score sum is exact and argmax ties resolve alike);
- gradients through a layout: exact (a masked copy of the upstream
  gradient);
- products through the plain versions of the n:m:g kernels: rtol = atol
  = 1e-5 (f32 sums in another order); the gradient of a squared product
  1e-4 (its two f32 sums compound);
- ``RandomFractionSparsifier``: its bits are ``torch.rand``'s, not
  ``jax.random``'s, so the kept share must lie within 5 binomial standard
  deviations of ``1 - fraction`` (a false failure has probability below
  1e-6), and a seeded generator must repeat its mask.
"""

import importlib
import math
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sten as jsten
from repro.core import layouts as jl
from repro.core import nmg as jnmg
from repro.core import sparsifiers as jsp
from repro.core.autograd import dense_grad_of as jax_dense_grad_of
from repro.core.autograd import sparsify_grads as jax_sparsify_grads
from repro.core.dispatch import OutFormat as JaxOutFormat
from repro.optim import value_and_grad_sparse
from repro_torch import sten
from repro_torch.core import autograd as tag_
from repro_torch.core import layouts as tl
from repro_torch.core import nmg as tnmg
from repro_torch.core import sparsifiers as tsp
from repro_torch.core.dispatch import reset_dispatch_counters
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
LAYOUTS = ("DenseTensor", "CsrTensor", "CooTensor", "FixedMaskTensor",
           "NMTensor", "GroupedNMTensor")


@pytest.fixture(autouse=True)
def _reset_port_counters():
    tops.reset_kernel_counters()
    reset_dispatch_counters()


def _np(t) -> np.ndarray:
    return t.detach().numpy()


def _rand(shape, seed=0, zeros=False, ints=False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if ints:
        return rng.integers(-9, 10, shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    if zeros:
        x[np.abs(x) < 0.6] = 0.0
    return x


def _both(x: np.ndarray):
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _same_fields(got, want, *names):
    for n in names:
        np.testing.assert_array_equal(_np(getattr(got, n)),
                                      np.asarray(getattr(want, n)), err_msg=n)


# ---------------------------------------------------------------------------
# layouts: round trips, stored fields, capacities
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 8), (16, 48), (7, 13), (1, 5)])
@pytest.mark.parametrize("zeros", [False, True], ids=["dense", "sparse"])
def test_csr_equals_reference(shape, zeros):
    """Exact round trip, and the reference's capacity, data, indices and
    indptr (padding slots included)."""
    x = _rand(shape, seed=1, zeros=zeros)
    xj, xt = _both(x)
    got, want = tl.CsrTensor.from_dense(xt), jl.CsrTensor.from_dense(xj)
    assert got.nnz_cap == want.nnz_cap and got.shape == want.shape
    _same_fields(got, want, "data", "indices", "indptr")
    np.testing.assert_array_equal(_np(got.to_dense()), x)
    assert got.density() == pytest.approx(want.density(), abs=1e-12)


@pytest.mark.parametrize("shape", [(4, 8), (3, 5, 7), (16,)])
@pytest.mark.parametrize("zeros", [False, True], ids=["dense", "sparse"])
def test_coo_equals_reference(shape, zeros):
    x = _rand(shape, seed=2, zeros=zeros)
    xj, xt = _both(x)
    got, want = tl.CooTensor.from_dense(xt), jl.CooTensor.from_dense(xj)
    assert got.nnz_cap == want.nnz_cap
    _same_fields(got, want, "data", "coords")
    np.testing.assert_array_equal(_np(got.to_dense()), x)
    assert got.density() == pytest.approx(want.density(), abs=1e-12)


@pytest.mark.parametrize("cls", ["CsrTensor", "CooTensor"])
@pytest.mark.parametrize("cap", [16, 3])
def test_capacity_as_reference(cls, cap):
    """A capacity above nnz pads inertly; one below drops the entries past
    it into the scratch slot (never clamped into the data), as the
    reference does."""
    x = np.zeros((6, 10), np.float32)
    x[1, 3], x[2, 0], x[4, 7], x[5, 9] = 2.5, 1.0, -1.25, 4.0
    xj, xt = _both(x)
    got = getattr(tl, cls).from_dense(xt, nnz_cap=cap)
    want = getattr(jl, cls).from_dense(xj, nnz_cap=cap)
    assert got.nnz_cap == cap
    np.testing.assert_array_equal(_np(got.to_dense()),
                                  np.asarray(want.to_dense()))
    if cap > 4:
        np.testing.assert_array_equal(_np(got.to_dense()), x)


def test_fixed_mask_roundtrip():
    x = _rand((8, 16), seed=3, zeros=True)
    t = tl.FixedMaskTensor.from_dense(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(t.to_dense()), x)
    assert t.density() == pytest.approx(float((x != 0).mean()))


@pytest.mark.parametrize("nm", [(1, 4), (2, 4), (1, 2), (3, 6), (2, 8)],
                         ids=lambda p: "{}:{}".format(*p))
@pytest.mark.parametrize("shape,ints", [((8, 48), False), ((5, 13), False),
                                        ((2, 3, 24), True)],
                         ids=["f32", "ragged", "ties"])
def test_nm_tensor_equals_reference(nm, shape, ints):
    """``NMTensor.from_dense`` (through the ``nm_mask`` kernel's rule)
    stores the reference's offsets and values (its ``lax.top_k``): ragged
    K padded with zeros, ties (small integers) to the lowest index."""
    n, m = nm
    x = _rand(shape, seed=4, ints=ints)
    xj, xt = _both(x)
    got = tl.NMTensor.from_dense(xt, n, m)
    want = jl.NMTensor.from_dense(xj, n, m)
    assert got.idx.dtype == torch.int32 and got.dense_shape == want.shape
    _same_fields(got, want, "val", "idx")
    np.testing.assert_array_equal(_np(got.to_dense()),
                                  np.asarray(want.to_dense()))
    assert tops.kernel_counters()[("nm_mask", "plain")] == 1


def test_nm_tensor_stacks_and_slices():
    """A per-layer built, stacked ``NMTensor`` keeps the per-layer
    ``dense_shape`` and slices back into the per-layer tensors."""
    x = torch.from_numpy(_rand((3, 16, 24), seed=5))
    parts = [tl.NMTensor.from_dense(xi, 2, 4) for xi in x.unbind(0)]
    st = tl.NMTensor.stack(parts)
    assert st.stacked and st.shape == (16, 24) and st.val.shape[0] == 3
    for p, q in zip(parts, st.unbind(0)):
        assert q.shape == (16, 24) and not q.stacked
        assert torch.equal(p.val, q.val) and torch.equal(p.idx, q.idx)
    assert torch.equal(st.to_dense(), torch.stack(
        [p.to_dense() for p in parts]))


@pytest.mark.parametrize("method", ["greedy", "swap", "exact"])
@pytest.mark.parametrize("fmt", [(2, 4, 1, 1, -1), (1, 4, 2, 2, 0)],
                         ids=["2:4:1", "1:4:2gr2_sd0"])
def test_nmg_methods_equal_reference(method, fmt):
    """Every conversion method picks the reference's permutation on
    integer inputs (exact score sums): the greedy first fit, the swap
    refinement seeded with it, and the brute-force oracle."""
    n, m, g, gr, sd = fmt
    x = _rand((8, 48) if sd == -1 else (48, 8), seed=6, ints=True)
    xj, xt = _both(x)
    got = tnmg.dense_to_grouped_nm(xt, n, m, g, gr=gr, sparse_dim=sd,
                                   method=method)
    want = jnmg.dense_to_grouped_nm(xj, n, m, g, gr=gr, sparse_dim=sd,
                                    method=method)
    _same_fields(got, want, "blk_idx", "val")
    np.testing.assert_array_equal(_np(got.to_dense()),
                                  np.asarray(want.to_dense()))
    e_got = float(tnmg.energy(got.to_dense(), xt))
    assert e_got == pytest.approx(float(jnmg.energy(want.to_dense(), xj)),
                                  abs=1e-7)


def test_swap_never_below_greedy():
    """On random inputs the swap refinement keeps at least the greedy
    energy, as the reference's does."""
    xt = torch.from_numpy(_rand((16, 96), seed=7))
    e = {mt: float(tnmg.energy(tnmg.dense_to_grouped_nm(
        xt, 2, 4, 2, method=mt).to_dense(), xt)) for mt in ("greedy", "swap")}
    assert e["swap"] >= e["greedy"] - 1e-6


def test_registry_equals_reference():
    builtin = {k for k, c in jl.all_layouts().items()
               if c.__module__.startswith("repro.")}
    mine = {k for k, c in tl.all_layouts().items()
            if c.__module__.startswith("repro_torch.")}
    assert mine == builtin == set(LAYOUTS)
    with pytest.raises(TypeError, match="to_dense"):
        tl.register_layout(type("NoDense", (tl.SparsityLayout,), {}))


# ---------------------------------------------------------------------------
# every registered layout: round trip, structure and gradients
# ---------------------------------------------------------------------------

CONSTRUCTORS = {
    "DenseTensor": (tl.DenseTensor, lambda x: jl.DenseTensor(x)),
    "CsrTensor": (tl.CsrTensor.from_dense, jl.CsrTensor.from_dense),
    "CooTensor": (tl.CooTensor.from_dense, jl.CooTensor.from_dense),
    "FixedMaskTensor": (tl.FixedMaskTensor.from_dense,
                        jl.FixedMaskTensor.from_dense),
    "NMTensor": (lambda x: tl.NMTensor.from_dense(x, 2, 4),
                 lambda x: jl.NMTensor.from_dense(x, 2, 4)),
    "GroupedNMTensor": (
        lambda x: tl.GroupedNMTensor.from_dense(x, 2, 4, g=2, gr=1),
        lambda x: jl.GroupedNMTensor.from_dense(x, 2, 4, g=2, gr=1)),
}
EXACT = {"DenseTensor", "CsrTensor", "CooTensor", "FixedMaskTensor"}


def test_every_registered_layout_is_covered():
    mine = {k for k, c in tl.all_layouts().items()
            if c.__module__.startswith("repro_torch.")}
    assert mine == set(CONSTRUCTORS)


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("shape", [(4, 8), (8, 48), (3, 96)])
def test_roundtrip_equals_reference(name, shape):
    """Kept values survive the round trip (every value for the exact
    layouts), and the densified tensor is the reference's."""
    x = _rand(shape, seed=8, zeros=name in EXACT, ints=name not in EXACT)
    xj, xt = _both(x)
    t = CONSTRUCTORS[name][0](xt)
    d = _np(t.to_dense())
    assert d.shape == shape and t.shape == shape
    kept = d != 0
    np.testing.assert_array_equal(d[kept], x[kept])
    if name in EXACT:
        np.testing.assert_array_equal(d, x)
    np.testing.assert_array_equal(
        d, np.asarray(CONSTRUCTORS[name][1](xj).to_dense()))


@pytest.mark.parametrize("name", ["NMTensor", "GroupedNMTensor"])
def test_block_sparsity_honored(name):
    d = _np(CONSTRUCTORS[name][0](torch.from_numpy(
        _rand((8, 96), seed=9))).to_dense())
    assert (d.reshape(8, -1, 4) != 0).sum(-1).max() <= 2


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("shape", [(4, 8), (8, 96)])
def test_grad_through_layout_equals_reference(name, shape):
    """d/dx sum(make(x).to_dense() * w): the upstream gradient at the kept
    positions and exactly 0 elsewhere, equal to ``jax.grad`` of the
    reference."""
    x, w = _rand(shape, seed=10), _rand(shape, seed=11)
    xj, xt = _both(x)
    make_t, make_j = CONSTRUCTORS[name]
    xt.requires_grad_(True)
    (make_t(xt).to_dense() * torch.from_numpy(w)).sum().backward()
    got = _np(xt.grad)
    want = np.asarray(jax.grad(
        lambda z: jnp.sum(make_j(z).to_dense() * jnp.asarray(w)))(xj))
    np.testing.assert_array_equal(got, want)
    keep = _np(make_t(torch.from_numpy(x)).to_dense()) != 0
    assert (got[~keep] == 0).all()


@pytest.mark.parametrize("name", LAYOUTS)
def test_grad_reaches_stored_values(name):
    """The gradient of a loss w.r.t. a layout reaches its value tensor
    (``grad_values``), of the stored shape, equal to the reference's
    layout-structured cotangent."""
    x = _rand((8, 96), seed=12)
    xj, xt = _both(x)
    t, tj = CONSTRUCTORS[name][0](xt), CONSTRUCTORS[name][1](xj)
    vals = tag_.grad_values(t).detach().requires_grad_(True)
    (tag_.with_values(t, vals).to_dense() ** 2).sum().backward()
    gj = jax.grad(lambda z: jnp.sum(z.to_dense() ** 2), allow_int=True)(tj)
    want = getattr(gj, "val", getattr(gj, "data", None))
    np.testing.assert_allclose(_np(vals.grad), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# sparsifiers
# ---------------------------------------------------------------------------

SPARSIFIERS = {
    "KeepAll": (), "RandomFractionSparsifier": (0.3,),
    "ScalarThresholdSparsifier": (0.5,), "NMSparsifier": (2, 4),
    "GroupedNMSparsifier": (1, 4, 2), "ScalarFractionSparsifier": (0.7,),
    "BlockwiseFractionSparsifier": (0.5, 4),
}


@pytest.mark.parametrize("name", sorted(SPARSIFIERS))
def test_taxonomy_equals_reference(name):
    """Table 1's class (``kind``) and passes, as the reference's."""
    args = SPARSIFIERS[name]
    got, want = getattr(tsp, name)(*args), getattr(jsp, name)(*args)
    assert (got.kind, got.passes) == (want.kind, want.passes)


@pytest.mark.parametrize("name", sorted(set(SPARSIFIERS)
                                        - {"RandomFractionSparsifier"}))
@pytest.mark.parametrize("shape", [(8, 32), (3, 16, 32)])
def test_masks_equal_reference(name, shape):
    """Every deterministic sparsifier's mask equals the reference's (a 3-D
    n:m:g leaf per layer; integer inputs keep n:m:g scores exact and the
    block sums of the block-wise fraction exact)."""
    args = SPARSIFIERS[name]
    if name == "GroupedNMSparsifier":
        args = args + (1, "greedy", 0)
    x = _rand(shape, seed=13, ints=name in ("GroupedNMSparsifier",
                                            "BlockwiseFractionSparsifier"))
    xj, xt = _both(x)
    got = getattr(tsp, name)(*args).mask(xt)
    want = getattr(jsp, name)(*args).mask(xj)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(_np(got), np.asarray(want).astype(bool))
    masked = getattr(tsp, name)(*args)(xt)
    np.testing.assert_array_equal(_np(masked), x * np.asarray(want))


def test_blockwise_drops_whole_blocks():
    m = _np(tsp.BlockwiseFractionSparsifier(0.5, block=4).mask(
        torch.from_numpy(_rand((4, 32), seed=14))))
    assert set(np.unique(m.reshape(4, 8, 4).sum(-1))) <= {0, 4}


def test_random_fraction_rate_and_determinism():
    """Kept share within 5 binomial standard deviations of 0.7, and a
    seeded generator repeats its mask."""
    x = torch.ones(64, 64)
    sp = tsp.RandomFractionSparsifier(0.3)

    def draw(seed):
        return sp.mask(x, torch.Generator().manual_seed(seed))

    kept = float(draw(5).float().mean())
    sd = math.sqrt(0.7 * 0.3 / x.numel())
    assert abs(kept - 0.7) < 5 * sd
    assert torch.equal(draw(5), draw(5)) and not torch.equal(draw(5),
                                                             draw(6))
    assert torch.equal(sp.mask(x), sp.mask(x))     # no generator: seed 0


@pytest.mark.parametrize("out", LAYOUTS)
def test_apply_sparsifier_reaches_every_layout(out):
    """Magnitude pruning to every output layout: the reference's densified
    result (n:m and n:m:g convert the masked tensor; integer inputs)."""
    x = _rand((8, 32), seed=15, ints=True)
    xj, xt = _both(x)
    sp_t, sp_j = tsp.ScalarFractionSparsifier(0.5), \
        jsp.ScalarFractionSparsifier(0.5)
    got = tsp.apply_sparsifier(sp_t, xt, getattr(tl, out))
    want = jsp.apply_sparsifier(sp_j, xj, getattr(jl, out))
    assert type(got).__name__ == type(want).__name__ == out
    np.testing.assert_array_equal(_np(got.to_dense()),
                                  np.asarray(want.to_dense()))


@pytest.mark.parametrize("impl", ["nm", "grouped_nm", "grouped_nm_mask"])
def test_registered_implementations_equal_reference(impl):
    """The three registered (sparsifier, Dense -> layout) implementations:
    n:m to ``NMTensor``, n:m:g to ``GroupedNMTensor`` and to a masked-dense
    ``FixedMaskTensor`` with the sparsifier as its origin."""
    x = _rand((16, 32), seed=16, ints=True)
    xj, xt = _both(x)
    sp = {"nm": ("NMSparsifier", (2, 4), "NMTensor"),
          "grouped_nm": ("GroupedNMSparsifier", (1, 4, 2, 2, "greedy", 0),
                         "GroupedNMTensor"),
          "grouped_nm_mask": ("GroupedNMSparsifier", (1, 4, 2, 2, "greedy",
                                                      0), "FixedMaskTensor")
          }[impl]
    st, sj = getattr(tsp, sp[0])(*sp[1]), getattr(jsp, sp[0])(*sp[1])
    assert tsp.lookup_sparsifier_impl(st, tl.DenseTensor,
                                      getattr(tl, sp[2])) is not None
    got = tsp.apply_sparsifier(st, xt, getattr(tl, sp[2]))
    want = jsp.apply_sparsifier(sj, xj, getattr(jl, sp[2]))
    np.testing.assert_array_equal(_np(got.to_dense()),
                                  np.asarray(want.to_dense()))
    if impl == "grouped_nm_mask":
        assert got.origin == st and got.mask.dtype == torch.bool
        np.testing.assert_array_equal(_np(got.mask), np.asarray(want.mask))


def _same_format_refs(x):
    """(port ref, jax ref) pairs of every layout SameFormatSparsifier
    takes, built from the same dense x."""
    xj, xt = _both(x)
    tfrac, jfrac = tsp.ScalarFractionSparsifier(0.5), \
        jsp.ScalarFractionSparsifier(0.5)
    return {
        "fixed_mask_origin": (
            tsp.apply_sparsifier(tfrac, xt, tl.FixedMaskTensor),
            jsp.apply_sparsifier(jfrac, xj, jl.FixedMaskTensor)),
        "fixed_mask_generic": (
            tl.FixedMaskTensor.from_dense(xt * (xt.abs() > 4)),
            jl.FixedMaskTensor.from_dense(xj * (jnp.abs(xj) > 4))),
        "grouped_nm": (
            tnmg.dense_to_grouped_nm(xt, 1, 4, 2, gr=2, sparse_dim=0),
            jnmg.dense_to_grouped_nm(xj, 1, 4, 2, gr=2, sparse_dim=0)),
        "nm": (tl.NMTensor.from_dense(xt, 2, 4),
               jl.NMTensor.from_dense(xj, 2, 4)),
        "csr": (tsp.apply_sparsifier(tfrac, xt, tl.CsrTensor),
                jsp.apply_sparsifier(jfrac, xj, jl.CsrTensor)),
        "coo": (tsp.apply_sparsifier(tfrac, xt, tl.CooTensor),
                jsp.apply_sparsifier(jfrac, xj, jl.CooTensor)),
        "dense": (tl.DenseTensor(xt), jl.DenseTensor(xj)),
    }


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "recompute"])
@pytest.mark.parametrize("ref", ["fixed_mask_origin", "fixed_mask_generic",
                                 "grouped_nm", "nm", "csr", "coo", "dense"])
def test_same_format_equals_reference(ref, fixed):
    """Every SameFormatSparsifier branch, fixed pattern and recomputed,
    on a new value: the reference's layout, fields and densified value
    (CSR/COO keep their capacity)."""
    x = _rand((16, 32), seed=17, ints=True)
    new = _rand((16, 32), seed=18, ints=True)
    rt, rj = _same_format_refs(x)[ref]
    nj, nt = _both(new)
    got = tsp.SameFormatSparsifier(fixed).resparsify(rt, nt)
    want = jsp.SameFormatSparsifier(fixed).resparsify(rj, nj)
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(_np(got.to_dense()),
                                  np.asarray(want.to_dense()))
    if ref in ("csr", "coo"):
        assert got.nnz_cap == rt.nnz_cap == want.nnz_cap
    if ref == "nm":
        _same_fields(got, want, "idx")
    if ref == "grouped_nm":
        _same_fields(got, want, "blk_idx")


def test_same_format_stacked_per_layer():
    """A stacked n:m:g leaf re-sparsifies layer by layer (the reference
    vmaps): each layer equals the unstacked re-sparsification."""
    x = torch.from_numpy(_rand((2, 32, 16), seed=19, ints=True))
    new = torch.from_numpy(_rand((2, 32, 16), seed=20, ints=True))
    parts = [tnmg.dense_to_grouped_nm(xi, 1, 4, 2, gr=2, sparse_dim=0)
             for xi in x.unbind(0)]
    st = tl.GroupedNMTensor.stack(parts)
    for fixed in (True, False):
        out = tsp.SameFormatSparsifier(fixed).resparsify(st, new)
        for i, p in enumerate(parts):
            one = tsp.SameFormatSparsifier(fixed).resparsify(p, new[i])
            assert torch.equal(out.layer(i).to_dense(), one.to_dense())


# ---------------------------------------------------------------------------
# gradients and gradient formats
# ---------------------------------------------------------------------------


def test_grad_through_fixed_mask_and_dense_grad_of():
    x = _rand((8, 8), seed=21)
    xj, xt = _both(x)
    wt = tsp.apply_sparsifier(tsp.ScalarFractionSparsifier(0.5), xt,
                              tl.FixedMaskTensor)
    wj = jsp.apply_sparsifier(jsp.ScalarFractionSparsifier(0.5), xj,
                              jl.FixedMaskTensor)
    v = wt.val.clone().requires_grad_(True)
    (tl.FixedMaskTensor(v, wt.mask).to_dense() ** 2).sum().backward()
    _, gj = value_and_grad_sparse(lambda p: jnp.sum(p.to_dense() ** 2))(wj)
    np.testing.assert_allclose(_np(v.grad), np.asarray(gj.val), rtol=1e-6)
    np.testing.assert_array_equal(
        _np(tag_.dense_grad_of(wt, v.grad)),
        np.asarray(jax_dense_grad_of(wj, gj)))


def test_dense_grad_of_nm_scatters_values():
    x = _rand((4, 16), seed=22)
    xj, xt = _both(x)
    t, tj = tl.NMTensor.from_dense(xt, 2, 4), jl.NMTensor.from_dense(xj, 2, 4)
    g = torch.from_numpy(_rand(tuple(t.val.shape), seed=23))
    gj = jl.NMTensor(jnp.asarray(g.numpy()), tj.idx, 2, 4, tj.dense_shape)
    np.testing.assert_array_equal(_np(tag_.dense_grad_of(t, g)),
                                  np.asarray(jax_dense_grad_of(tj, gj)))


def test_masked_grad_and_straight_through():
    g, m = torch.ones(4, 4), torch.eye(4, dtype=torch.bool)
    assert float(sten.masked_grad(g, m).sum()) == 4.0
    assert sten.straight_through(g) is g


@pytest.mark.parametrize("leaf", ["tensor", "fixed_mask"])
def test_sparsify_grads_equals_reference(leaf):
    """The named gradient is re-sparsified with the format's external
    sparsifier (the reference's values); others are left alone; a
    FixedMaskTensor gradient keeps its mask and origin."""
    g = _rand((8, 8), seed=24)
    gj, gt = _both(g)
    fmt_t = sten.OutFormat(tsp.KeepAll(), None,
                           tsp.ScalarFractionSparsifier(0.75),
                           tl.FixedMaskTensor)
    fmt_j = JaxOutFormat(jsp.KeepAll(), None,
                         jsp.ScalarFractionSparsifier(0.75),
                         jl.FixedMaskTensor)
    origin = tsp.ScalarFractionSparsifier(0.5)
    if leaf == "fixed_mask":
        mask = np.abs(g) > 0.3
        gt = tl.FixedMaskTensor(gt, torch.from_numpy(mask), origin)
        gj = jl.FixedMaskTensor(gj, None, jsp.ScalarFractionSparsifier(0.5))
        gt.mask = None        # a cotangent: val holds the dense gradient
    b = np.ones(8, np.float32)
    got = sten.sparsify_grads({"w": gt, "b": torch.from_numpy(b)},
                              {"w": fmt_t})
    want = jax_sparsify_grads({"w": gj, "b": jnp.asarray(b)}, {"w": fmt_j})
    w_got = got["w"].val if leaf == "fixed_mask" else got["w"]
    w_want = want["w"].val if leaf == "fixed_mask" else want["w"]
    np.testing.assert_array_equal(_np(w_got), np.asarray(w_want))
    assert (_np(w_got) == 0).mean() > 0.5
    np.testing.assert_array_equal(_np(got["b"]), b)
    if leaf == "fixed_mask":
        assert got["w"].origin is origin


def test_loss_grad_through_sparse_linear():
    """The gradient of a loss through ``sten.linear`` with an n:m:g weight
    (the plain versions of the kernels here) reaches the compressed
    values, equal to the reference's."""
    x, w = _rand((4, 96), seed=25), _rand((96, 32), seed=26, ints=True)
    (xj, xt), (wj, wt) = _both(x), _both(w)
    tw = tnmg.dense_to_grouped_nm(wt, 2, 4, 2, sparse_dim=0)
    jw = jnmg.dense_to_grouped_nm(wj, 2, 4, 2, sparse_dim=0)
    v = tw.val.clone().requires_grad_(True)
    (sten.linear(xt, tag_.with_values(tw, v)) ** 2).sum().backward()
    _, gj = value_and_grad_sparse(
        lambda p: jnp.sum(jsten.linear(xj, p) ** 2))(jw)
    # 2 * x^T y, with y itself a sum of 96 f32 products in another order:
    # relative error a few 1e-5 where y nearly cancels
    np.testing.assert_allclose(_np(v.grad), np.asarray(gj.val), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the reference's examples through repro_torch.sten
# ---------------------------------------------------------------------------


def test_quickstart_sequence_equals_reference():
    """``examples/quickstart.py``'s steps 1-4 through both packages on the
    same inputs: CSR density, the CSR product, the warned dense fallback,
    the sparsified add's layout and values, the n:m:g linear and its
    energy.  (Step 5, the model, is ``tests/test_torch_builder.py``'s.)"""
    from repro_torch.core.dispatch import SparseFallbackWarning

    x, b = _rand((8, 16), seed=27), _rand((16, 4), seed=28)
    (xj, xt), (bj, bt) = _both(x), _both(b)
    csr = sten.apply_sparsifier(sten.ScalarFractionSparsifier(0.7), xt,
                                tl.CsrTensor)
    csr_j = jsten.apply_sparsifier(jsten.ScalarFractionSparsifier(0.7), xj,
                                   jl.CsrTensor)
    assert csr.density() == pytest.approx(csr_j.density())
    np.testing.assert_allclose(_np(sten.matmul(csr, bt)),
                               np.asarray(jsten.matmul(csr_j, bj)),
                               **F32_TOL)
    with pytest.warns(SparseFallbackWarning):
        r = sten.relu(csr)
    np.testing.assert_array_equal(_np(r), np.maximum(_np(csr.to_dense()), 0))
    sparse_add = sten.sparsified_op(torch.add, sten.OutFormat(
        sten.KeepAll(), None, sten.RandomFractionSparsifier(0.5),
        tl.CsrTensor))
    c = sparse_add(torch.ones(4, 4), torch.ones(4, 4),
                   generator=torch.Generator().manual_seed(0))
    assert isinstance(c, tl.CsrTensor)
    assert set(np.unique(_np(c.to_dense()))) <= {0.0, 2.0}
    w, a = _rand((64, 32), seed=29, ints=True), _rand((4, 64), seed=30)
    (wj, wt), (aj, at) = _both(w), _both(a)
    w_nmg = sten.dense_to_grouped_nm(wt, n=1, m=4, g=16, sparse_dim=0)
    w_nmg_j = jsten.dense_to_grouped_nm(wj, n=1, m=4, g=16, sparse_dim=0)
    out = sten.linear(at, w_nmg)
    np.testing.assert_allclose(_np(out), np.asarray(jsten.linear(
        aj, w_nmg_j)), **F32_TOL)
    np.testing.assert_allclose(_np(out), _np(at @ w_nmg.to_dense()),
                               **F32_TOL)
    assert float(sten.energy(w_nmg.to_dense(), wt)) == pytest.approx(
        float(jsten.energy(w_nmg_j.to_dense(), wj)), abs=1e-7)


def _reference_custom_layout():
    """The reference's ``examples/custom_layout.py`` module (imported once
    a process: importing it registers its layout)."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        return importlib.import_module("custom_layout")
    finally:
        sys.path.remove(str(ROOT / "examples"))


@sten.register_layout
class BandTensor(tl.SparsityLayout):
    """``examples/custom_layout.py``'s diagonal band layout, written
    against ``repro_torch.sten``: the diagonals of a band of width 2r+1."""

    def __init__(self, diags, r, dense_shape):
        self.diags, self.r, self.dense_shape = diags, r, dense_shape

    @property
    def shape(self):
        return tuple(self.dense_shape)

    @property
    def dtype(self):
        return self.diags.dtype

    def to_dense(self):
        n = self.dense_shape[0]
        out = torch.zeros(self.dense_shape, dtype=self.diags.dtype)
        for i, off in enumerate(range(-self.r, self.r + 1)):
            out = out + torch.diag(self.diags[i, :n - abs(off)], off)
        return out


class BandSparsifier(tsp.Sparsifier):
    kind = "streaming"

    def __init__(self, r):
        self.r = r

    def mask(self, x, generator=None):
        i = torch.arange(x.shape[0])[:, None]
        j = torch.arange(x.shape[1])[None, :]
        return (i - j).abs() <= self.r


@sten.register_sparsifier_implementation(BandSparsifier, tl.DenseTensor,
                                         BandTensor)
def _dense_to_band(sp, x, generator=None):
    x = x.to_dense() if hasattr(x, "to_dense") else x
    n = x.shape[0]
    rows = [torch.nn.functional.pad(torch.diagonal(x, off),
                                    (0, n - (n - abs(off))))
            for off in range(-sp.r, sp.r + 1)]
    return BandTensor(torch.stack(rows), sp.r, tuple(x.shape))


@sten.register_op_impl("matmul", inp=(BandTensor, tl.DenseTensor),
                       out=tl.DenseTensor)
def _band_matmul(a: BandTensor, b):
    b = b.to_dense() if hasattr(b, "to_dense") else b
    n = a.dense_shape[0]
    out = torch.zeros((n, b.shape[1]), dtype=b.dtype)
    for i, off in enumerate(range(-a.r, a.r + 1)):
        ln = n - abs(off)
        d = a.diags[i, :ln]
        if off >= 0:
            out[:ln] += d[:, None] * b[off:off + ln]
        else:
            out[-off:-off + ln] += d[:, None] * b[:ln]
    return out


def test_custom_layout_extension_equals_reference():
    """The paper's extensibility demo: one layout class, one sparsifier
    registration and one operator registration make a usable layout.  The
    band's storage, its product (its own implementation, no warning) and
    the warned fallback equal the reference example's on the same
    inputs."""
    from repro.core.dispatch import SparseFallbackWarning as JaxWarning
    from repro_torch.core.dispatch import SparseFallbackWarning

    ref = _reference_custom_layout()
    x, b = _rand((16, 16), seed=31), _rand((16, 8), seed=32)
    (xj, xt), (bj, bt) = _both(x), _both(b)
    band = sten.apply_sparsifier(BandSparsifier(2), xt, BandTensor)
    band_j = jsten.apply_sparsifier(ref.BandSparsifier(2), xj, ref.BandTensor)
    np.testing.assert_array_equal(_np(band.diags), np.asarray(band_j.diags))
    np.testing.assert_array_equal(_np(band.to_dense()),
                                  np.asarray(band_j.to_dense()))
    with warnings.catch_warnings():
        warnings.simplefilter("error", SparseFallbackWarning)
        y = sten.matmul(band, bt)
    np.testing.assert_allclose(_np(y), np.asarray(jsten.matmul(band_j, bj)),
                               **F32_TOL)
    np.testing.assert_allclose(_np(y), _np(band.to_dense() @ bt), **F32_TOL)
    with pytest.warns(SparseFallbackWarning):
        z = sten.relu(band)
    with pytest.warns(JaxWarning):
        zj = jsten.relu(band_j)
    np.testing.assert_array_equal(_np(z), np.asarray(zj))


def test_torch_tensor_to_csr():
    x = _rand((6, 9), seed=33)
    xj, xt = _both(x)
    got = sten.torch_tensor_to_csr(sten.ScalarFractionSparsifier(0.5), xt)
    want = jsten.torch_tensor_to_csr(jsten.ScalarFractionSparsifier(0.5), xj)
    _same_fields(got, want, "data", "indices", "indptr")


@pytest.mark.parametrize("recompute", [False, True],
                         ids=["fixed", "recompute"])
@pytest.mark.parametrize("leaf", ["nm", "nm_stacked", "grouped_nm_stacked"])
def test_resparsify_params_layout_leaves_equal_reference(leaf, recompute):
    """``resparsify_params`` over n:m and n:m:g leaves (a stacked leaf per
    layer) after their stored values changed: the reference's values and
    pattern; the in-place spelling writes the same into the leaf's own
    tensors."""
    from repro.optim.sparse_update import resparsify_params as jax_resp
    from repro_torch.optim.sparse_update import resparsify_params, \
        resparsify_params_

    stacked = leaf != "nm"
    x = _rand((2, 16, 32) if stacked else (16, 32), seed=34, ints=True)
    xj, xt = _both(x)
    if leaf.startswith("nm"):
        t = [tl.NMTensor.from_dense(v, 2, 4) for v in xt.unbind(0)] \
            if stacked else tl.NMTensor.from_dense(xt, 2, 4)
        j = [jl.NMTensor.from_dense(xj[i], 2, 4) for i in range(2)] \
            if stacked else jl.NMTensor.from_dense(xj, 2, 4)
        t = tl.NMTensor.stack(t) if stacked else t
    else:
        t = tl.GroupedNMTensor.stack([tnmg.dense_to_grouped_nm(
            v, 1, 4, 2, gr=2, sparse_dim=0) for v in xt.unbind(0)])
        j = [jnmg.dense_to_grouped_nm(xj[i], 1, 4, 2, gr=2, sparse_dim=0)
             for i in range(2)]
    if isinstance(j, list):
        j = jax.tree_util.tree_map(lambda *v: jnp.stack(v), *j)
    # new stored values: the optimizer moved them
    noise = _rand(tuple(t.val.shape), seed=35, ints=True)
    t = tag_.with_values(t, t.val + torch.from_numpy(noise))
    leaves, aux = j.tree_flatten()
    j = type(j).tree_unflatten(aux, (j.val + jnp.asarray(noise),)
                               + tuple(leaves[1:]))
    got = resparsify_params({"w": t}, recompute_pattern=recompute)["w"]
    want = jax_resp({"w": j}, recompute_pattern=recompute)["w"]
    np.testing.assert_array_equal(_np(got.val), np.asarray(want.val))
    index = "idx" if leaf.startswith("nm") else "blk_idx"
    np.testing.assert_array_equal(_np(getattr(got, index)),
                                  np.asarray(getattr(want, index)))
    resparsify_params_({"w": t}, recompute_pattern=recompute)
    assert torch.equal(t.val, got.val)
    assert torch.equal(getattr(t, index), getattr(got, index))
