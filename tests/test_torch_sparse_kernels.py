"""The port's training-side kernels (``nm_mask``, ``matmul_threshold``)
against the JAX package's, on the same numpy inputs.

On this host the port's wrappers run their plain PyTorch versions (the
tensors lie on the CPU); they are held against the reference's Pallas
kernels in interpret mode and against its ``kernels/ref.py`` oracles.
The CUDA kernels are held against the plain versions by
``tests/test_torch_cuda.py`` on the card.

Tolerances: ``nm_mask`` is a comparison network with a fixed tie rule, so
the masks must be equal bit for bit, ties and ragged blocks included.
``matmul_threshold`` sums in another order than XLA, so in f32 the values
agree within rtol = atol = 1e-5, and a mask entry may differ only where
``|y_ref|`` lies within 1e-5 * max(1, t) of the threshold t (counted, and
asserted to be few); its gradients agree with ``jax.grad`` of the
reference within 1e-5.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jsten
from repro.core.dispatch import SparseFallbackWarning as JaxFallbackWarning
from repro.core.layouts import FixedMaskTensor as JaxFixedMask
from repro.core.sparsifiers import ScalarThresholdSparsifier as JaxThreshold
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.common import mm as jax_mm
from repro_torch import bridge
from repro_torch.core import ops as tsten
from repro_torch.core.dispatch import SparseFallbackWarning, \
    dispatch_counters, reset_dispatch_counters
from repro_torch.core.layouts import FixedMaskTensor
from repro_torch.core.sparsifiers import ScalarThresholdSparsifier
from repro_torch.kernels import fused_sparse_matmul, nm_mask
from repro_torch.kernels import ops as tops
from repro_torch.models.common import mm

# the last two are wider than the CUDA kernel's register array (m > 16),
# which takes them through its loop
NM = [(1, 4), (2, 4), (2, 8), (3, 6), (1, 10), (5, 20), (16, 32)]
SHAPES = [(32, 64), (7, 130), (256, 520)]
MT_SHAPES = [(32, 48, 40), (64, 64, 64), (33, 70, 9)]
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _reset_port_counters():
    tops.reset_kernel_counters()
    reset_dispatch_counters()


def _both(x: np.ndarray, dtype):
    """The same values as a JAX array and a CPU torch tensor."""
    xj = jnp.asarray(x, dtype)
    return xj, bridge.tensor_from_numpy(np.asarray(xj), device="cpu")


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,m", NM)
@pytest.mark.parametrize("shape", SHAPES)
def test_nm_mask_equals_reference(shape, n, m, dtype):
    xj, xt = _both(np.random.default_rng(0).standard_normal(shape), dtype)
    got = tops.nm_mask(xt, n, m)
    assert got.dtype == torch.bool and got.shape == xt.shape
    got = got.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.nm_mask(xj, n, m, use_pallas=True)))
    np.testing.assert_array_equal(got, np.asarray(jref.nm_mask_ref(xj, n, m)))
    assert tops.kernel_counters()[("nm_mask", "plain")] == 1


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,m", NM)
def test_nm_mask_ties_and_ragged_blocks(n, m, dtype):
    """Ties resolve to the lowest index exactly as ``lax.top_k``: small
    integers (many ties), an all-equal row, a row of zeros, zeros next to
    the zero padding of a ragged last block (K % m != 0), and a stacked
    [L, R, K] leaf."""
    rng = np.random.default_rng(1)
    x = rng.integers(-2, 3, (3, 16, 131)).astype(np.float32)
    x[0, 0] = 1.5
    x[0, 1] = 0.0
    x[1, 2, -7:] = 0.0
    xj, xt = _both(x, dtype)
    got = tops.nm_mask(xt, n, m).numpy()
    want = np.asarray(jref.nm_mask_ref(xj, n, m))
    np.testing.assert_array_equal(got, want)
    x2 = xj.reshape(-1, x.shape[-1])
    np.testing.assert_array_equal(
        got.reshape(-1, x.shape[-1]),
        np.asarray(jops.nm_mask(x2, n, m, use_pallas=True)))


#: magnitudes at the edges of the rank rule: signed zeros, subnormals
#: (ranked as 0), the smallest normal, infinities, and a few ordinary values
SPECIAL = np.array([0.0, -0.0, 1e-40, -1e-40, 2e-39, -2e-39,
                    np.finfo(np.float32).tiny, np.inf, -np.inf, 1.0, -0.5,
                    2.0], np.float32)


def special_blocks(m: int, seed: int, nan: bool) -> np.ndarray:
    """[16, 2m + 3] (a ragged last block) of values drawn from SPECIAL, each
    row biased toward zeros and subnormals so blocks hold ties among them;
    with ``nan`` a few NaNs too."""
    rng = np.random.default_rng(seed)
    p = np.full(SPECIAL.size, 1.0)
    p[:6] = 4.0
    x = rng.choice(SPECIAL, size=(16, 2 * m + 3), p=p / p.sum())
    if nan:
        x[rng.random(x.shape) < 0.1] = np.nan
    return x.astype(np.float32)


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,m", NM)
def test_nm_mask_special_values_equal_reference(n, m, dtype):
    """The reference ranks a subnormal |x| as 0 (its Pallas kernel in both
    dtypes, its ``lax.top_k`` route in bf16), keeps a NaN whenever n > 0
    without counting it against the others (Pallas), and breaks ties
    toward the lowest index.  The port equals the Pallas route bitwise in
    both dtypes, with and without NaN, and the ``top_k`` route in bf16
    without NaN (the two reference routes disagree on NaN, and on f32
    subnormals)."""
    for nan in (False, True):
        xj, xt = _both(special_blocks(m, 7 * m + n, nan), dtype)
        got = tops.nm_mask(xt, n, m).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jops.nm_mask(xj, n, m, use_pallas=True)))
        if dtype == jnp.bfloat16 and not nan:
            np.testing.assert_array_equal(
                got, np.asarray(jref.nm_mask_ref(xj, n, m)))


def _boundary_ok(got_mask, want_mask, y_ref, t):
    """Mask entries that differ lie on the threshold boundary; returns
    how many differ."""
    diff = got_mask != want_mask
    near = np.abs(np.abs(y_ref) - t) <= 1e-5 * max(1.0, abs(t))
    assert not (diff & ~near).any(), "mask differs off the boundary"
    assert diff.sum() <= max(2, diff.size // 1000)
    return int(diff.sum())


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("threshold", [0.5, 2.0])
@pytest.mark.parametrize("shape", MT_SHAPES)
def test_matmul_threshold_equals_reference(shape, threshold):
    M, K, N = shape
    rng = np.random.default_rng(2)
    aj, at = _both(rng.standard_normal((M, K)), jnp.float32)
    bj, bt = _both(rng.standard_normal((K, N)), jnp.float32)
    val, mask = tops.matmul_threshold(at, bt, threshold)
    assert val.dtype == torch.float32 and mask.dtype == torch.bool
    v_p, m_p = jops.matmul_threshold(aj, bj, threshold, use_pallas=True)
    v_r, m_r = jref.matmul_threshold_ref(aj, bj, threshold)
    y_ref = np.asarray(aj @ bj)
    for v_want, m_want in ((v_p, m_p), (v_r, m_r)):
        m_want = np.asarray(m_want)
        _boundary_ok(mask.numpy(), m_want, y_ref, threshold)
        same = mask.numpy() == m_want
        np.testing.assert_allclose(val.numpy()[same],
                                   np.asarray(v_want)[same], **F32_TOL)


@pytest.mark.parametrize("threshold", [0.5, 2.0])
@pytest.mark.parametrize("shape", MT_SHAPES)
def test_matmul_threshold_gradients_equal_reference(shape, threshold):
    """d/da and d/db of sum(val * r) through the autograd function equal
    ``jax.grad`` through the reference's oracle."""
    M, K, N = shape
    rng = np.random.default_rng(3)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    r = rng.standard_normal((M, N)).astype(np.float32)

    def jloss(aa, bb):
        v, _ = jref.matmul_threshold_ref(aa, bb, threshold)
        return jnp.sum(v * r)

    ga, gb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    val, mask = fused_sparse_matmul.matmul_threshold(at, bt, threshold)
    (val * torch.from_numpy(r)).sum().backward()
    _, m_r = jref.matmul_threshold_ref(jnp.asarray(a), jnp.asarray(b),
                                       threshold)
    assert _boundary_ok(mask.numpy(), np.asarray(m_r), a @ b, threshold) == 0
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga), **F32_TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), **F32_TOL)


def test_matmul_threshold_bf16_operands():
    """bf16 operands (the training path's dtype): f32 products are exact,
    only the order of the f32 sums differs, so values agree within
    rtol = atol = 1e-4 and the bf16 gradients within one bf16 step."""
    rng = np.random.default_rng(4)
    aj, at = _both(rng.standard_normal((48, 96)), jnp.bfloat16)
    bj, bt = _both(rng.standard_normal((96, 40)), jnp.bfloat16)
    v_r, m_r = jref.matmul_threshold_ref(aj, bj, 0.5)
    at.requires_grad_(True)
    val, mask = fused_sparse_matmul.matmul_threshold(at, bt, 0.5)
    y_ref = np.asarray(aj.astype(jnp.float32) @ bj.astype(jnp.float32))
    _boundary_ok(mask.numpy(), np.asarray(m_r), y_ref, 0.5)
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(v_r),
                               rtol=1e-4, atol=1e-4)
    val.sum().backward()
    assert at.grad.dtype == torch.bfloat16
    ga = jax.grad(lambda x: jnp.sum(jref.matmul_threshold_ref(x, bj, 0.5)[0])
                  )(aj)
    np.testing.assert_allclose(at.grad.float().numpy(),
                               np.asarray(ga.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-3)


def test_mm_inline_threshold_reaches_the_fused_kernel():
    """``mm(x, w, inline=ScalarThreshold)`` on a dense weight dispatches
    to the fused implementation (one ``matmul_threshold`` call, no dense
    fallback) and equals the reference's ``mm``."""
    rng = np.random.default_rng(5)
    xj, xt = _both(rng.standard_normal((3, 8, 32)), jnp.float32)
    wj, wt = _both(rng.standard_normal((32, 16)), jnp.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error", SparseFallbackWarning)
        y = mm(xt, wt, inline=ScalarThresholdSparsifier(0.5))
    assert y.shape == (3, 8, 16) and y.dtype == torch.float32
    assert tops.kernel_counters()[("matmul_threshold", "plain")] == 1
    assert dispatch_counters() == {
        ("impl", "matmul", ("DenseTensor", "DenseTensor")): 1}
    want = np.asarray(jax_mm(xj, wj, inline=JaxThreshold(0.5)))
    np.testing.assert_allclose(y.numpy(), want, **F32_TOL)


DISPATCH = ["dense_masked_matmul", "masked_dense_matmul",
            "masked_linear_bias", "masked_linear_post_sparsifier",
            "dense_fallback"]


@pytest.mark.parametrize("case", DISPATCH)
def test_dispatch_routes_equal_reference(case):
    """The registered masked-dense implementations, the post-sparsifier
    route (an inline sparsifier with no fused implementation) and the
    dense fallback (``relu``, an op with no sparse implementation, which
    warns in both packages) give the reference's values.  (FixedMask,
    FixedMask) ``matmul`` converts an operand losslessly in both packages:
    ``tests/test_torch_dispatch.py`` holds that route.)"""
    rng = np.random.default_rng(6)
    xj, xt = _both(rng.standard_normal((6, 32)), jnp.float32)
    mask = rng.random((32, 32)) < 0.5
    wj = JaxFixedMask(jnp.asarray(rng.standard_normal((32, 32)) * mask,
                                  jnp.float32), jnp.asarray(mask))
    wt = FixedMaskTensor(torch.from_numpy(np.array(wj.val)),
                         torch.from_numpy(mask))
    bj, bt = _both(rng.standard_normal(32), jnp.float32)
    calls = {
        "dense_masked_matmul": lambda s, x, w, b: s.matmul(x, w),
        "masked_dense_matmul": lambda s, x, w, b: s.matmul(w, x.T),
        "masked_linear_bias": lambda s, x, w, b: s.linear(x, w, b),
        "masked_linear_post_sparsifier": lambda s, x, w, b: s.linear(
            x, w, inline=(JaxThreshold if s is jsten
                          else ScalarThresholdSparsifier)(1.0)),
        "dense_fallback": lambda s, x, w, b: s.relu(w),
    }[case]
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = calls(jsten, xj, wj, bj)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = calls(tsten, xt, wt, bt)
    fell_back = case == "dense_fallback"
    assert any(issubclass(w.category, JaxFallbackWarning)
               for w in jw) == fell_back
    assert any(issubclass(w.category, SparseFallbackWarning)
               for w in tw) == fell_back
    outcome = next(iter(dispatch_counters()))[0]
    assert outcome == ("dense_fallback" if fell_back else "impl")
    np.testing.assert_allclose(_np_out(got), np.asarray(want), **F32_TOL)


def _np_out(t):
    return (t.to_dense() if isinstance(t, FixedMaskTensor) else t).numpy()


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """No fallback: a CPU tensor takes the plain version and counts no
    launch; the CUDA path validates its operands before any build."""
    x = torch.randn(4, 8)
    before = (nm_mask.nm_mask.launches,
              fused_sparse_matmul.matmul_threshold.launches)
    nm_mask.nm_mask(x, 2, 4)
    fused_sparse_matmul.matmul_threshold(x, torch.randn(8, 3), 0.5)
    assert (nm_mask.nm_mask.launches,
            fused_sparse_matmul.matmul_threshold.launches) == before
    # a meta operand takes the meta route (shape and dtype, no launch);
    # the launch paths refuse anything off the card
    m = nm_mask.nm_mask(x.to("meta"), 2, 4)
    assert (m.device.type, m.shape, m.dtype) == ("meta", x.shape, torch.bool)
    val, mask = fused_sparse_matmul.matmul_threshold(
        x.to("meta"), torch.randn(8, 3).to("meta"), 0.5)
    assert (val.device.type, tuple(val.shape), val.dtype) == \
        ("meta", (4, 3), torch.float32) and mask.dtype == torch.bool
    assert (nm_mask.nm_mask.launches,
            fused_sparse_matmul.matmul_threshold.launches) == before
    with pytest.raises(ValueError):
        nm_mask._launch(x.to("meta"), 2, 4)
    with pytest.raises(ValueError):
        fused_sparse_matmul._launch(x.to("meta"), torch.randn(8, 3), 0.5)
