"""The port's dispatcher against the JAX package's: registered
implementations, the lossless-conversion table and search, ``predict_route``
over every signature of the built-in layouts, the measured-cost tie-break,
the dense fallback and its per-signature warning, sparse operators
(``sparsified_op``) with fused and unfused inline sparsifiers, the patching
API and the paper's extensibility example, on the same numpy inputs.

Tolerances: routes, conversion pairs, warnings, layouts and stored fields
are compared exactly; products that both packages compute in f32 in
another summation order within rtol = atol = 1e-5; the fused
inline-threshold product's mask may differ only where the reference's
value lies within 1e-5 of the threshold (none do on these inputs).
The counters are compared as route keys and conversion pairs, never as
raw counts: the reference counts traces, the port calls.
"""

import importlib
import itertools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sten as jsten
from repro.core import layouts as jl
from repro.core import sparsifiers as jsp
from repro.core.convert import conversion_log as jax_conversion_log
from repro.core.convert import convert as jax_convert
from repro.core.convert import lossless_targets as jax_lossless
from repro.core.dispatch import SparseFallbackWarning as JaxWarning
from repro.core.dispatch import predict_route as jax_predict
from repro.core.dispatch import set_conversion_cost_model as jax_set_cost
from repro.core.ops import sum_ as jsum
from repro_torch import sten
from repro_torch.core import layouts as tl
from repro_torch.core import sparsifiers as tsp
from repro_torch.core.dispatch import SparseFallbackWarning
from repro_torch.core.ops import sum_ as tsum
from repro_torch.kernels import ops as tops

# the modules (each package re-exports functions named after them)
tconv = importlib.import_module("repro_torch.core.convert")
tdisp = importlib.import_module("repro_torch.core.dispatch")
jdisp = importlib.import_module("repro.core.dispatch")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
LAYOUTS = ("DenseTensor", "CsrTensor", "CooTensor", "FixedMaskTensor",
           "NMTensor", "GroupedNMTensor")


@pytest.fixture(autouse=True)
def _reset_port_state():
    tops.reset_kernel_counters()
    tdisp.reset_dispatch_counters()
    tconv.reset_conversion_log()
    yield
    tdisp.set_conversion_cost_model(None)
    jax_set_cost(None)


def _np(t) -> np.ndarray:
    return t.detach().numpy()


def _rand(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x: np.ndarray):
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _sparse(x, frac=0.6, layout="CsrTensor"):
    """(port, reference) magnitude-pruned layouts of the same x."""
    xj, xt = _both(x)
    return (tsp.apply_sparsifier(tsp.ScalarFractionSparsifier(frac), xt,
                                 getattr(tl, layout)),
            jsp.apply_sparsifier(jsp.ScalarFractionSparsifier(frac), xj,
                                 getattr(jl, layout)))


def _layout_pair(name: str, x: np.ndarray):
    """(port, reference) ``name`` layouts of the same x: magnitude-pruned
    for the unstructured ones, 2:4 (and 2:4:1) for the structured."""
    if name == "NMTensor":
        return (tl.NMTensor.from_dense(torch.from_numpy(x), 2, 4),
                jl.NMTensor.from_dense(jnp.asarray(x), 2, 4))
    if name == "GroupedNMTensor":
        return (tl.GroupedNMTensor.from_dense(torch.from_numpy(x), 2, 4, 1),
                jl.GroupedNMTensor.from_dense(jnp.asarray(x), 2, 4, 1))
    return _sparse(x, 0.5, name)


def _builtin_table(table, pkg: str) -> list:
    """Registered (op, layout names, inline name) keys of the built-in
    layouts, in registration order (other tests may register more)."""
    out = []
    for (op, sig, inline) in table:
        if all(c.__module__.startswith(pkg) for c in sig):
            out.append((op, tuple(c.__name__ for c in sig),
                        None if inline is None else inline.__name__))
    return out


def test_op_table_equals_reference():
    """The same implementations, registered in the same order (the
    conversion search's tie-break), with the same output layouts."""
    got = _builtin_table(tdisp.sparse_op_table(), "repro_torch.")
    want = _builtin_table(jdisp.sparse_op_table(), "repro.")
    assert got == want
    for (key, fn), (jkey, jfn) in zip(
            [(k, v) for k, v in tdisp.sparse_op_table().items()
             if all(c.__module__.startswith("repro_torch.") for c in k[1])],
            [(k, v) for k, v in jdisp.sparse_op_table().items()
             if all(c.__module__.startswith("repro.") for c in k[1])]):
        assert fn._sten_out_layout.__name__ == jfn._sten_out_layout.__name__
        assert getattr(fn, "_sten_fused", False) == getattr(
            jfn, "_sten_fused", False)


@pytest.mark.parametrize("src", LAYOUTS)
def test_lossless_table_equals_reference(src):
    """The reference's conversion table exactly, and ``convert`` raising
    on every lossy target in both packages."""
    got = [c.__name__ for c in tconv.lossless_targets(getattr(tl, src))]
    want = [c.__name__ for c in jax_lossless(getattr(jl, src))]
    assert got == want
    t, j = _layout_pair(src, _rand((8, 16), seed=1))
    for dst in LAYOUTS:
        if dst in want:
            out = tconv.convert(t, getattr(tl, dst))
            assert type(out).__name__ == dst
            np.testing.assert_array_equal(
                _np(out.to_dense()),
                np.asarray(jax_convert(j, getattr(jl, dst)).to_dense()))
        else:
            with pytest.raises(TypeError, match="no lossless conversion"):
                tconv.convert(t, getattr(tl, dst))
            with pytest.raises(TypeError, match="no lossless conversion"):
                jax_convert(j, getattr(jl, dst))


ROUTE_CASES = (
    [(op, sig, None) for op in ("matmul", "linear", "add")
     for sig in itertools.product(LAYOUTS, repeat=2)]
    + [("matmul", sig, "ScalarThresholdSparsifier")
       for sig in itertools.product(LAYOUTS, repeat=2)]
    + [(op, (lay,), None) for op in ("relu", "gelu", "sum")
       for lay in LAYOUTS])


@pytest.mark.parametrize("op", ["matmul", "linear", "add", "matmul+inline",
                                "unary"])
def test_predict_route_equals_reference(op):
    """``predict_route`` over every signature of the built-in layouts
    gives the reference's outcome, target signature, conversions and
    warning, and leaves the counters untouched."""
    cases = [c for c in ROUTE_CASES if (
        (op == "unary" and len(c[1]) == 1)
        or (op == "matmul+inline" and c[2] is not None)
        or (c[0] == op and len(c[1]) == 2 and c[2] is None))]
    assert cases
    for name, sig, inline in cases:
        got = tdisp.predict_route(
            name, tuple(getattr(tl, s) for s in sig),
            inline=None if inline is None else getattr(tsp, inline))
        want = jax_predict(
            name, tuple(getattr(jl, s) for s in sig),
            inline=None if inline is None else getattr(jsp, inline))
        assert got == want, (name, sig, inline)
    assert tdisp.dispatch_counters() == {}


def test_find_impl_prefers_exact_then_fewest_conversions():
    impl, sig = tdisp._find_impl("matmul", (tl.CsrTensor, tl.DenseTensor),
                                 None)
    assert impl is not None and sig is None
    r = tdisp.predict_route("matmul", (tl.CooTensor, tl.DenseTensor))
    assert r["conversions"] == (("CooTensor", "CsrTensor"),)


def test_cost_model_breaks_ties_as_reference():
    """(COO, Dense) matmul ties between (CSR, Dense) and (FixedMask,
    Dense), one conversion each.  Registration order picks CSR; a cost
    model that measures both pairs and prices FixedMask lower picks it and
    counts an override; one that leaves a pair unmeasured keeps
    registration order.  Both packages agree at every step."""
    def cost(measured):
        def fn(src, dst):
            pair = (src.__name__, dst.__name__)
            return {("CooTensor", "FixedMaskTensor"): 1.0,
                    ("CooTensor", "CsrTensor"): 5.0}.get(pair) \
                if measured or pair[1] == "CsrTensor" else None
        return fn

    x = _rand((8, 12), seed=2)
    for measured, want_target in ((None, "CsrTensor"),
                                  (True, "FixedMaskTensor"),
                                  (False, "CsrTensor")):
        fn = None if measured is None else cost(measured)
        tdisp.set_conversion_cost_model(fn)
        jax_set_cost(fn)
        assert tdisp.conversion_cost_model() is fn
        got = tdisp.predict_route("matmul", (tl.CooTensor, tl.DenseTensor))
        want = jax_predict("matmul", (jl.CooTensor, jl.DenseTensor))
        assert got == want and got["target_sig"][0] == want_target
        tdisp.reset_dispatch_counters()
        tconv.reset_conversion_log()
        a = tl.CooTensor.from_dense(torch.from_numpy(x))
        b = torch.from_numpy(_rand((12, 5), seed=3))
        np.testing.assert_allclose(_np(sten.matmul(a, b)),
                                   _np(torch.from_numpy(x) @ b), **F32_TOL)
        assert (("cost_model_override", "matmul", ("CooTensor",
                                                   "DenseTensor"))
                in tdisp.dispatch_counters()) == (measured is True)
        assert tconv.conversion_log() == [("CooTensor", want_target,
                                           (8, 12))]


@pytest.mark.parametrize("case", ["csr_dense", "dense_csr", "coo_via_csr",
                                  "masked_pair", "nm_dense", "nm_linear",
                                  "nmg_matmul"])
def test_products_equal_reference(case):
    """Each registered or conversion-reached product: the reference's
    route (its conversion pairs, no fallback warning) and values."""
    a, b = _rand((8, 12), seed=4), _rand((12, 16), seed=5)
    (aj, at), (bj, bt) = _both(a), _both(b)
    ints = np.random.default_rng(6).integers(-9, 10, (16, 12)).astype(
        np.float32)
    if case == "csr_dense":
        t, j = _sparse(a)
        args = ((t, bt), (j, bj))
    elif case == "dense_csr":
        t, j = _sparse(b)
        args = ((at, t), (aj, j))
    elif case == "coo_via_csr":
        t, j = _sparse(a, layout="CooTensor")
        args = ((t, bt), (j, bj))
    elif case == "masked_pair":
        (t, j), (u, k) = _sparse(a, layout="FixedMaskTensor"), \
            _sparse(b, layout="FixedMaskTensor")
        args = ((t, u), (j, k))
    elif case == "nm_dense":
        args = ((tl.NMTensor.from_dense(at, 2, 4), bt),
                (jl.NMTensor.from_dense(aj, 2, 4), bj))
    elif case == "nm_linear":
        args = ((bt.T.contiguous(), tl.NMTensor.from_dense(at.T, 2, 4)),
                (bj.T, jl.NMTensor.from_dense(aj.T, 2, 4)))
    else:
        wj, wt = _both(ints)
        args = ((tl.GroupedNMTensor.from_dense(wt, 1, 4, 1, sparse_dim=1),
                 bt[:, :4].T.contiguous()),
                (jl.GroupedNMTensor.from_dense(wj, 1, 4, 1, sparse_dim=1),
                 bj[:, :4].T))
    fn_t = sten.linear if case == "nm_linear" else sten.matmul
    fn_j = jsten.linear if case == "nm_linear" else jsten.matmul
    with warnings.catch_warnings():
        warnings.simplefilter("error", SparseFallbackWarning)
        got = fn_t(*args[0])
    with warnings.catch_warnings():
        warnings.simplefilter("error", JaxWarning)
        want = fn_j(*args[1])
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    assert {k[:2] for k in tdisp.dispatch_counters()} == {
        ("impl", "linear" if case == "nm_linear" else "matmul")}
    assert [c[:2] for c in tconv.conversion_log()] == [
        c[:2] for c in jax_conversion_log()]


def test_grouped_nm_matmul_needs_sparse_dim_1():
    w = tl.GroupedNMTensor.from_dense(torch.ones(16, 12), 1, 4, 1,
                                      sparse_dim=0)
    with pytest.raises(NotImplementedError, match="sparse_dim=1"):
        sten.matmul(w, torch.ones(16, 3))


def test_coo_keepall_add_union_equals_reference():
    """Keep-all sparse add is the union of the nonzeros: the reference's
    concatenated entries."""
    x1, x2 = np.zeros((4, 4), np.float32), np.zeros((4, 4), np.float32)
    x1[0, 0], x2[3, 3], x2[0, 0] = 1.0, 2.0, 0.5
    (j1, t1), (j2, t2) = _both(x1), _both(x2)
    got = sten.add(tl.CooTensor.from_dense(t1), tl.CooTensor.from_dense(t2))
    want = jsten.add(jl.CooTensor.from_dense(j1), jl.CooTensor.from_dense(j2))
    assert isinstance(got, tl.CooTensor)
    np.testing.assert_array_equal(_np(got.data), np.asarray(want.data))
    np.testing.assert_array_equal(_np(got.coords), np.asarray(want.coords))
    np.testing.assert_array_equal(_np(got.to_dense()), x1 + x2)


FALLBACK_OPS = {"relu": (sten.relu, jsten.relu),
                "gelu": (sten.gelu, jsten.gelu),
                "sum": (tsum, jsum)}


@pytest.mark.parametrize("op", sorted(FALLBACK_OPS))
def test_dense_fallback_warns_and_equals_reference(op):
    """No implementation: densify, the dense reference (``gelu`` the tanh
    approximation, as ``jax.nn.gelu``), and one warning."""
    t, j = _sparse(_rand((4, 4), seed=7))
    fn_t, fn_j = FALLBACK_OPS[op]
    with pytest.warns(SparseFallbackWarning):
        got = fn_t(t)
    with pytest.warns(JaxWarning):
        want = fn_j(j)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


def test_all_dense_short_circuit():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = sten.matmul(torch.ones(2, 3), torch.ones(3, 2))
    np.testing.assert_array_equal(_np(out), 3 * np.ones((2, 2)))
    assert tdisp.dispatch_counters() == {}


def test_dense_tensor_wrappers_do_not_warn_on_fallback():
    with warnings.catch_warnings():
        warnings.simplefilter("error", SparseFallbackWarning)
        out = sten.relu(tl.DenseTensor(torch.tensor([-1.0, 2.0])))
    np.testing.assert_array_equal(_np(out), [0.0, 2.0])


def test_fallback_warning_dedupes_per_signature():
    """The warning fires once per (op, signature) while the counter counts
    every call; another signature warns afresh; a reset re-arms it."""
    t, _ = _sparse(_rand((4, 4), seed=8))
    with pytest.warns(SparseFallbackWarning):
        sten.relu(t)
    with warnings.catch_warnings():
        warnings.simplefilter("error", SparseFallbackWarning)
        sten.relu(t)
    assert tdisp.dispatch_counters()[
        ("dense_fallback", "relu", ("CsrTensor",))] == 2
    with pytest.warns(SparseFallbackWarning):
        sten.relu(tl.CooTensor.from_dense(torch.from_numpy(_rand((4, 4)))))
    tdisp.reset_dispatch_counters()
    with pytest.warns(SparseFallbackWarning):
        sten.relu(t)


class _FixedSparsifier(tsp.Sparsifier):
    """Keeps a given mask: the same selection in both packages, so the
    rest of the ``sparsified_op`` pipeline can be held to the
    reference's."""

    def __init__(self, mask):
        self.keep = mask

    def mask(self, x, generator=None):
        return torch.from_numpy(self.keep)


class _JaxFixedSparsifier(jsp.Sparsifier):
    def __init__(self, mask):
        self.keep = mask

    def mask(self, x, key=None):
        return jnp.asarray(self.keep)


@pytest.mark.parametrize("out", ["CsrTensor", "CooTensor",
                                 "FixedMaskTensor", "DenseTensor"])
def test_sparsified_op_equals_reference(out):
    """``sparsified_op(add, (KeepAll, Dense, external, out))`` with the
    same mask in both packages: the reference's output layout and stored
    fields."""
    mask = np.random.default_rng(9).random((8, 8)) < 0.5
    a, b = _rand((8, 8), seed=10), _rand((8, 8), seed=11)
    (aj, at), (bj, bt) = _both(a), _both(b)
    op = sten.sparsified_op(torch.add, sten.OutFormat(
        tsp.KeepAll(), tl.DenseTensor, _FixedSparsifier(mask),
        getattr(tl, out)))
    jop = jsten.sparsified_op(jnp.add, jsten.OutFormat(
        jsp.KeepAll(), jl.DenseTensor, _JaxFixedSparsifier(mask),
        getattr(jl, out)))
    got, want = op(at, bt), jop(aj, bj)
    assert type(got).__name__ == type(want).__name__ == out
    np.testing.assert_array_equal(_np(got.to_dense()),
                                  np.asarray(want.to_dense()))
    for field in ("data", "indices", "indptr", "coords"):
        if hasattr(want, field):
            np.testing.assert_array_equal(_np(getattr(got, field)),
                                          np.asarray(getattr(want, field)))
    assert op.out_fmt.out_layout is getattr(tl, out)
    assert op.__name__ == "sparse_add"


def test_sparsified_op_random_fraction():
    """The random external sparsifier: CSR out, values in {0, 2}, the
    kept share within 5 binomial standard deviations of 0.5, repeatable
    under a seeded generator."""
    op = sten.sparsified_op(torch.add, sten.OutFormat(
        tsp.KeepAll(), tl.DenseTensor, tsp.RandomFractionSparsifier(0.5),
        tl.CsrTensor))

    def run():
        return op(torch.ones(32, 32), torch.ones(32, 32),
                  generator=torch.Generator().manual_seed(3))

    out = run()
    assert isinstance(out, tl.CsrTensor)
    assert abs(out.density() - 0.5) < 5 * (0.25 / 1024) ** 0.5
    assert set(np.unique(_np(out.to_dense()))) <= {0.0, 2.0}
    assert torch.equal(out.to_dense(), run().to_dense())


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_inline_threshold_equals_reference(fused):
    """``sparsified_op(matmul, (ScalarThreshold, FixedMask, KeepAll,
    FixedMask))``.  On ``DenseTensor`` operands the (Dense, Dense)
    implementation fuses the threshold (one ``matmul_threshold`` call, no
    post-sparsifier); on plain tensors the all-dense path applies it after
    the product, as the reference does.  Both equal the reference's."""
    a, b = _rand((16, 32), seed=12), _rand((32, 16), seed=13)
    (aj, at), (bj, bt) = _both(a), _both(b)
    fmt = (tsp.ScalarThresholdSparsifier(1.0), tl.FixedMaskTensor,
           tsp.KeepAll(), tl.FixedMaskTensor)
    jfmt = (jsp.ScalarThresholdSparsifier(1.0), jl.FixedMaskTensor,
            jsp.KeepAll(), jl.FixedMaskTensor)
    op = sten.sparsified_op("matmul", fmt, dense_fn=torch.matmul)
    jop = jsten.sparsified_op("matmul", jfmt, dense_fn=jnp.matmul)
    wrap_t = tl.DenseTensor if fused else (lambda z: z)
    wrap_j = jl.DenseTensor if fused else (lambda z: z)
    with warnings.catch_warnings():
        warnings.simplefilter("error", SparseFallbackWarning)
        got = op(wrap_t(at), wrap_t(bt))
    want = jop(wrap_j(aj), wrap_j(bj))
    assert isinstance(got, tl.FixedMaskTensor)
    np.testing.assert_allclose(_np(got.to_dense()),
                               np.asarray(want.to_dense()), **F32_TOL)
    ref = np.asarray(aj @ bj)
    assert not (np.abs(np.abs(ref) - 1.0) < 1e-5).any()
    np.testing.assert_array_equal(_np(got.mask), np.abs(ref) >= 1.0)
    calls = tops.kernel_counters().get(("matmul_threshold", "plain"), 0)
    assert calls == (1 if fused else 0)
    if fused:
        assert tdisp.dispatch_counters() == {
            ("impl", "matmul", ("DenseTensor", "DenseTensor")): 1}


@pytest.mark.parametrize("case", ["fused_via_conversion", "post_sparsifier"])
def test_inline_routes_equal_reference(case):
    """An inline sparsifier on a sparse operand.  ``fused_via_conversion``:
    (CSR, Dense) ``matmul`` reaches the fused (Dense, Dense) threshold
    implementation by densifying the CSR operand.  ``post_sparsifier``:
    ``linear`` has no fused implementation, so (Dense, NM) runs the
    (Dense, FixedMask) one through the lossless conversion, then the
    sparsifier.  Both: the reference's route and values."""
    x = _rand((8, 12), seed=14)
    b = _rand((12, 4), seed=15)
    (xj, xt), (bj, bt) = _both(x), _both(b)
    if case == "fused_via_conversion":
        t, j = _sparse(x)
        name, args_t, args_j = "matmul", (t, bt), (j, bj)
    else:
        name = "linear"
        args_t = (bt.T.contiguous(), tl.NMTensor.from_dense(xt.T, 2, 4))
        args_j = (bj.T, jl.NMTensor.from_dense(xj.T, 2, 4))
    got = getattr(sten, name)(*args_t,
                              inline=tsp.ScalarThresholdSparsifier(0.5))
    want = getattr(jsten, name)(*args_j,
                                inline=jsp.ScalarThresholdSparsifier(0.5))
    if case == "fused_via_conversion":
        assert isinstance(got, tl.FixedMaskTensor)
        assert isinstance(want, jl.FixedMaskTensor)
        got, want = got.to_dense(), want.to_dense()
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    sig_t = tuple(type(tconv.as_layout(a)) for a in args_t)
    sig_j = tuple(type(jl.DenseTensor(a)) if not isinstance(
        a, jl.SparsityLayout) else type(a) for a in args_j)
    assert tdisp.predict_route(name, sig_t,
                               inline=tsp.ScalarThresholdSparsifier) == \
        jax_predict(name, sig_j, inline=jsp.ScalarThresholdSparsifier)
    assert [c[:2] for c in tconv.conversion_log()] == [
        c[:2] for c in jax_conversion_log()]


def test_patched_op_api():
    def external_lib_scale(x, factor=2.0):
        return x * factor

    patched = sten.register_patched_op(external_lib_scale, "external_scale")
    np.testing.assert_array_equal(_np(patched(torch.ones(3))), 2 * np.ones(3))
    t, _ = _sparse(_rand((4, 4), seed=16))
    with pytest.warns(SparseFallbackWarning):
        out = patched(t)
    np.testing.assert_array_equal(_np(out), _np(t.to_dense() * 2.0))
    assert patched.__name__ == "external_scale"


def test_register_op_impl_records_dense_reference():
    """A callable op doubles as its dense reference: a signature with no
    implementation nor conversion path falls back to it, warned."""
    def triple_ref_op(x):
        return x * 3.0

    @sten.register_op_impl(triple_ref_op, inp=(tl.GroupedNMTensor,))
    def _nmg_triple(a):  # pragma: no cover - never reached here
        return a.to_dense() * 3.0

    t, _ = _sparse(_rand((4, 4), seed=17))
    with pytest.warns(SparseFallbackWarning):
        out = tdisp.dispatch("triple_ref_op", t)
    np.testing.assert_array_equal(_np(out), _np(t.to_dense() * 3.0))
    with pytest.raises(ValueError, match="duplicate"):
        sten.register_op_impl(triple_ref_op, inp=(tl.GroupedNMTensor,))(
            _nmg_triple)


def _csc_class(base, csr, register):
    """The paper's §3.1 example layout (CSC), for either package."""
    class CscTensor(base):
        def __init__(self, data, indices, indptr, dense_shape):
            self.data, self.indices, self.indptr = data, indices, indptr
            self.dense_shape = dense_shape

        @property
        def shape(self):
            return tuple(self.dense_shape)

        @property
        def dtype(self):
            return self.data.dtype

        def to_dense(self):
            return csr(self.data, self.indices, self.indptr,
                       (self.dense_shape[1], self.dense_shape[0])
                       ).to_dense().T

        def tree_flatten(self):
            return (self.data, self.indices, self.indptr), \
                (self.dense_shape,)

        @classmethod
        def tree_unflatten(cls, aux, children):
            return cls(*children, *aux)

    return register(CscTensor)


_TCSC = _csc_class(tl.SparsityLayout, tl.CsrTensor, sten.register_layout)
_JCSC = _csc_class(jl.SparsityLayout, jl.CsrTensor, jsten.register_layout)


def test_extensibility_paper_example():
    """A user CSC layout with one sparsifier registration is fully
    usable: ``matmul`` reaches the (Dense, CSR) implementation through
    two lossless conversions (CSC -> Dense -> CSR) with no warning, the
    reference's route; ``relu`` falls back, warned."""
    @sten.register_sparsifier_implementation(_FixedSparsifier, tl.DenseTensor,
                                             _TCSC)
    def _to_csc(sp, x, generator=None):
        dense = x.to_dense()
        t = tl.CsrTensor.from_dense((dense * sp.mask(dense)).T)
        return _TCSC(t.data, t.indices, t.indptr, tuple(dense.shape))

    x = _rand((6, 10), seed=18)
    mask = np.random.default_rng(19).random((6, 10)) < 0.5
    t = sten.apply_sparsifier(_FixedSparsifier(mask), torch.from_numpy(x),
                              _TCSC)
    d = _np(t.to_dense())
    np.testing.assert_array_equal(d, x * mask)
    assert tdisp.predict_route("matmul", (_TCSC, tl.DenseTensor)) == \
        jax_predict("matmul", (_JCSC, jl.DenseTensor))
    with warnings.catch_warnings():
        warnings.simplefilter("error", SparseFallbackWarning)
        y = sten.matmul(t, torch.eye(10))
    np.testing.assert_allclose(_np(y), d, **F32_TOL)
    assert [c[:2] for c in tconv.conversion_log()] == [
        ("CscTensor", "DenseTensor"),
        ("DenseTensor", "CsrTensor")]
    with pytest.warns(SparseFallbackWarning):
        z = sten.relu(t)
    np.testing.assert_array_equal(_np(z), np.maximum(d, 0))
