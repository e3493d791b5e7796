"""The port's n:m:g kernels against the JAX package's, on the same
storage (the reference's conversion carried over by the bridge).

On this host the port's wrappers run their plain PyTorch versions (the
tensors lie on the CPU); those are held against the reference's Pallas
kernels in interpret mode and its XLA twins, in f32 with rtol = atol =
1e-5 — the summation order differs between the packages, the arithmetic
does not.  The CUDA kernels themselves are held against the plain
versions by ``tests/test_torch_cuda.py``, which runs on the card."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.nmg_fused import nmg_ffn_pallas, nmg_qkv_pallas
from repro.kernels.nmg_gemv import nmg_gemv_pallas
from repro.kernels.nmg_spmm import nmg_spmm_pallas
from repro_torch import bridge
from repro_torch.kernels import nmg_fused, nmg_gemv, nmg_spmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.common import mm_gated
from repro_torch.tune import routing

from tests._torch_compat import jax_dense_to_grouped_nm, nmg_to_numpy

F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 storage and activations, f32 accumulation in both packages: the
# products are exact in f32, only the order of the f32 sums differs, so
# the f32 outputs agree to f32 rounding of sums of ~K terms of size ~1
BF16_F32OUT_TOL = dict(rtol=1e-4, atol=1e-4)

# (n, m, g, gr, R, K): the serving format 1:4:8 (K exact and K padded)
# and a 2:4 format with padded R
FORMATS = [(1, 4, 8, 16, 32, 128), (1, 4, 8, 16, 48, 64), (2, 4, 2, 4, 10, 96)]
FMT_IDS = ["{}:{}:{}gr{}_{}x{}".format(*f) for f in FORMATS]
# every gr the reference takes, beyond the CUDA tiles: the paper's
# per-fiber gr 1, an odd gr 3 with padded R, and gr 24 (not a multiple of
# the 16-row tile); R = 48 is also a packed gated weight with F = 24
ANY_GR = [(1, 4, 8, 1, 48, 128), (1, 4, 8, 3, 46, 128),
          (1, 4, 8, 24, 48, 128)]
ANY_GR_IDS = ["gr{}_{}x{}".format(*f[3:]) for f in ANY_GR]
# packed gated weights [128, 48] (F = 24, no padded rows) at those gr
FFN_ANY_GR = [(1, 4, 8, gr, 48, 128) for gr in (1, 3, 24)]
# a packed gated-MLP weight [K, 2F] = [128, 64]: F = 32 = 2 fiber groups
FFN_FMT = (1, 4, 8, 16, 64, 128)


@functools.lru_cache(maxsize=None)
def _weights(fmt, count=1, dtype=jnp.float32, seed=0):
    """Reference conversions of [K, R] weights stored sparse along K
    (the serving orientation), and their bridged port twins."""
    n, m, g, gr, R, K = fmt
    rng = np.random.default_rng(seed)
    refs = [jax_dense_to_grouped_nm(
        jnp.asarray(rng.standard_normal((K, R)), dtype), n=n, m=m, g=g,
        gr=gr, sparse_dim=0) for _ in range(count)]
    ports = [bridge.params_from_numpy(nmg_to_numpy(t), device="cpu")
             for t in refs]
    return refs, ports


def _b(K, M, dtype=np.float32, seed=1):
    b = np.random.default_rng(seed).standard_normal((K, M)).astype(dtype)
    return jnp.asarray(b), torch.from_numpy(b)


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("fmt,M", [(FORMATS[0], 1), (FORMATS[0], 16),
                                   (FORMATS[2], 3), (ANY_GR[0], 4),
                                   (ANY_GR[1], 5), (ANY_GR[2], 16)],
                         ids=[f"{FMT_IDS[0]}-1", f"{FMT_IDS[0]}-16",
                              f"{FMT_IDS[2]}-3", f"{ANY_GR_IDS[0]}-4",
                              f"{ANY_GR_IDS[1]}-5", f"{ANY_GR_IDS[2]}-16"])
def test_gemv_plain_matches_reference(fmt, M):
    (ref,), (port,) = _weights(fmt)
    jb, tb = _b(fmt[5], M)
    got = nmg_gemv.nmg_gemv(port, tb).numpy()
    np.testing.assert_allclose(got, np.asarray(
        nmg_gemv_pallas(ref, jb, interpret=True)), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.nmg_gemv_xla(ref, jb)),
                               **F32_TOL)
    got_t = nmg_gemv.nmg_gemv(port, tb, transpose_out=True).numpy()
    np.testing.assert_allclose(got_t, np.asarray(
        jops.nmg_gemv_xla(ref, jb, transpose_out=True)), **F32_TOL)
    np.testing.assert_allclose(got, tref.nmg_spmm_ref(port, tb).numpy(),
                               **F32_TOL)


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("fmt,stream", [(FORMATS[1], True),
                                        (FORMATS[1], False),
                                        (FORMATS[2], True),
                                        (ANY_GR[0], True), (ANY_GR[1], True),
                                        (ANY_GR[2], False)],
                         ids=[f"{FMT_IDS[1]}-stream", f"{FMT_IDS[1]}-grid",
                              f"{FMT_IDS[2]}-stream",
                              f"{ANY_GR_IDS[0]}-stream",
                              f"{ANY_GR_IDS[1]}-stream",
                              f"{ANY_GR_IDS[2]}-grid"])
def test_spmm_plain_matches_reference(fmt, stream):
    N = 17
    (ref,), (port,) = _weights(fmt)
    jb, tb = _b(fmt[5], N)
    got = nmg_spmm.nmg_spmm(port, tb)
    assert got.dtype == torch.float32 and got.shape == (fmt[4], N)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        nmg_spmm_pallas(ref, jb, interpret=True, stream=stream, tn=32)),
        **F32_TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jops.nmg_spmm_xla(ref, jb)),
                               **F32_TOL)


def test_spmm_plain_blocked_equals_unblocked():
    """The block cap only bounds memory: a one-group-per-block run gives
    the one-block answer bitwise (each group's einsum is the same)."""
    _, (port,) = _weights(FORMATS[0])
    _, tb = _b(FORMATS[0][5], 24)
    whole = nmg_spmm.nmg_spmm_plain(port, tb)
    tiny = nmg_spmm.nmg_spmm_plain(port, tb, block_elems=1)
    assert torch.equal(whole, tiny)


@pytest.mark.pallas_interpret
def test_qkv_plain_matches_reference():
    M = 8
    refs, ports = _weights(FORMATS[0], count=3)
    jb, tb = _b(FORMATS[0][5], M)
    got = nmg_fused.nmg_qkv(ports, tb, transpose_out=True)
    want_p = nmg_qkv_pallas(tuple(refs), jb, interpret=True)
    want_x = jops.nmg_qkv_xla(tuple(refs), jb, transpose_out=True)
    oracle = tref.nmg_qkv_ref(ports, tb)
    for g_, wp, wx, o in zip(got, want_p, want_x, oracle):
        np.testing.assert_allclose(g_.numpy(), np.asarray(wp).T, **F32_TOL)
        np.testing.assert_allclose(g_.numpy(), np.asarray(wx), **F32_TOL)
        np.testing.assert_allclose(g_.numpy(), o.T.numpy(), **F32_TOL)


@pytest.mark.pallas_interpret
def test_bf16_gemv_and_spmm_match_reference():
    """bf16 storage and activations: f32 outputs within BF16_F32OUT_TOL,
    and the bf16 epilogue within one bf16 rounding step (2**-8 relative)
    plus the f32 tolerance."""
    (ref,), (port,) = _weights(FORMATS[0], dtype=jnp.bfloat16)
    b = np.asarray(jnp.asarray(np.random.default_rng(1).standard_normal(
        (128, 4)), jnp.bfloat16))
    jb, tb = jnp.asarray(b), bridge.tensor_from_numpy(b, device="cpu")
    np.testing.assert_allclose(
        nmg_gemv.nmg_gemv(port, tb).numpy(),
        np.asarray(nmg_gemv_pallas(ref, jb, interpret=True)),
        **BF16_F32OUT_TOL)
    got16 = nmg_gemv.nmg_gemv(port, tb, out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got16.float().numpy(),
        np.asarray(jops.nmg_gemv_xla(ref, jb, out_dtype=jnp.bfloat16),
                   np.float32), rtol=2 ** -7, atol=1e-4)
    b2 = np.asarray(jnp.asarray(np.random.default_rng(2).standard_normal(
        (128, 20)), jnp.bfloat16))
    np.testing.assert_allclose(
        nmg_spmm.nmg_spmm(port, bridge.tensor_from_numpy(b2, "cpu")).numpy(),
        np.asarray(nmg_spmm_pallas(ref, jnp.asarray(b2), interpret=True,
                                   tn=32)), **BF16_F32OUT_TOL)


@pytest.mark.parametrize("fmt", FORMATS, ids=FMT_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_plain_cast_and_transpose_epilogue(dtype, fmt):
    """``out_dtype`` / ``transpose_out`` are one cast of the f32 sum and
    the [N, R] orientation: bitwise ``.to(dtype).T`` of the f32 output,
    written contiguous."""
    _, (port,) = _weights(fmt)
    port = port.to(dtype=dtype)
    _, tb = _b(fmt[5], 20)
    tb = tb.to(dtype)
    f32 = nmg_spmm.nmg_spmm(port, tb)
    assert f32.dtype == torch.float32 and f32.shape == (fmt[4], 20)
    got = nmg_spmm.nmg_spmm(port, tb, out_dtype=dtype, transpose_out=True)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, f32.to(dtype).T)
    assert torch.equal(nmg_spmm.nmg_spmm(port, tb, transpose_out=True),
                       f32.T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_qkv_bitwise_equals_sequential(dtype):
    """One fused call over q/k/v equals three single calls bit for bit."""
    _, ports = _weights(FORMATS[0], count=3)
    ports = [p.to(dtype=dtype) for p in ports]
    _, tb = _b(FORMATS[0][5], 4)
    tb = tb.to(dtype)
    fused = nmg_fused.nmg_qkv(ports, tb, out_dtype=dtype, transpose_out=True)
    for f, w in zip(fused, ports):
        seq = nmg_gemv.nmg_gemv(w, tb, out_dtype=dtype, transpose_out=True)
        assert torch.equal(f, seq)


@pytest.mark.parametrize("M,route", [(1, "gemv"), (16, "gemv"),
                                     (17, "spmm"), (33, "spmm")])
def test_linear_routes_on_m(M, route):
    """nmg_linear takes GEMV for M <= 16 and SpMM above, as the counters
    show, and both regimes return x.dtype in [M, N] order."""
    (ref,), (port,) = _weights(FORMATS[0])
    x = np.random.default_rng(5).standard_normal((M, 128)).astype(np.float32)
    tops.reset_kernel_counters()
    y = tops.nmg_linear(torch.from_numpy(x), port)
    c = tops.kernel_counters()
    assert c == {("nmg_linear", f"{route}[default]"): 1,
                 (f"nmg_{route}", "plain"): 1}
    assert y.dtype == torch.float32 and y.shape == (M, 32)
    np.testing.assert_allclose(y.numpy(), np.asarray(
        jops.nmg_linear(jnp.asarray(x), ref)), **F32_TOL)


@pytest.mark.parametrize("M,route", [(16, "gemv"), (17, "spmm")])
def test_matmul_routes_on_m_with_f32_output(M, route):
    (ref,), (port,) = _weights(FORMATS[0])
    jb, tb = _b(128, M)
    tops.reset_kernel_counters()
    y = tops.nmg_matmul(port, tb)
    assert tops.kernel_counters() == {("nmg_matmul", f"{route}[default]"): 1,
                                      (f"nmg_{route}", "plain"): 1}
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jops.nmg_matmul(ref, jb)),
                               **F32_TOL)


def test_fused_qkv_routing():
    _, ports = _weights(FORMATS[0], count=3)
    tops.reset_kernel_counters()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 3, 128)).astype(np.float32))
    ys = tops.maybe_fused_qkv(x, ports)
    assert [tuple(y.shape) for y in ys] == [(2, 3, 32)] * 3
    assert tops.kernel_counters() == {("nmg_qkv", "fused[default]"): 1,
                                      ("nmg_qkv", "plain"): 1}
    assert tops.maybe_fused_qkv(torch.zeros(17, 128), ports) is None
    assert tops.maybe_fused_qkv(x, [ports[0], torch.zeros(128, 32),
                                    ports[2]]) is None


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is only for CPU tensors.  A meta tensor takes the
    wrappers' meta route (its output's shape and dtype, nothing run or
    launched: the dry-run's), never the plain version; the kernel's
    launch path refuses any operand off the card."""
    _, (port,) = _weights(FORMATS[0])
    b = torch.empty((128, 4), device="meta")
    for mod, name in ((nmg_gemv, "nmg_gemv_plain"),
                      (nmg_spmm, "nmg_spmm_plain"),
                      (nmg_fused, "nmg_qkv_plain")):
        monkeypatch.setattr(mod, name, lambda *a, **k: pytest.fail(name))
    before = (nmg_gemv.nmg_gemv.launches, nmg_spmm.nmg_spmm.launches,
              nmg_fused.nmg_qkv.launches)
    R = port.canonical_rows()
    out = nmg_gemv.nmg_gemv(port, b)
    assert (out.device.type, tuple(out.shape), out.dtype) == \
        ("meta", (R, 4), torch.float32)
    out = nmg_spmm.nmg_spmm(port, torch.empty((128, 40), device="meta"),
                            transpose_out=True)
    assert (out.device.type, tuple(out.shape)) == ("meta", (40, R))
    outs = nmg_fused.nmg_qkv([port] * 3, b)
    assert [tuple(o.shape) for o in outs] == [(R, 4)] * 3
    assert (nmg_gemv.nmg_gemv.launches, nmg_spmm.nmg_spmm.launches,
            nmg_fused.nmg_qkv.launches) == before
    with pytest.raises(ValueError, match="not CUDA"):
        nmg_gemv.gemv_launch([port], b)


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ffn_plain_matches_reference(act, M):
    """The fused gated FFN's plain version against the reference's Pallas
    kernel (interpret mode), its XLA twin and the port's oracle."""
    (ref,), (port,) = _weights(FFN_FMT)
    jb, tb = _b(FFN_FMT[5], M)
    got = nmg_fused.nmg_ffn(port, tb, act=act)
    assert got.shape == (32, M) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(
        nmg_ffn_pallas(ref, jb, act=act, interpret=True)), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jops.nmg_ffn_xla(ref, jb, act=act)), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), tref.nmg_ffn_ref(
        port, tb, act=act).numpy(), **F32_TOL)
    got_t = nmg_fused.nmg_ffn(port, tb, act=act, transpose_out=True)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(
        jops.nmg_ffn_xla(ref, jb, act=act, transpose_out=True)), **F32_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_bitwise_equals_sequential(dtype, act):
    """The fused route equals the model's own sequential projection,
    split and gate bit for bit, in one routed call."""
    _, (port,) = _weights(FFN_FMT)
    port = port.to(dtype=dtype)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 2, 128)).astype(np.float32)).to(dtype)
    tops.reset_kernel_counters()
    fused = tops.maybe_fused_ffn(x, port, act=act)
    assert tops.kernel_counters() == {("nmg_ffn", "fused[default]"): 1,
                                      ("nmg_ffn", "plain"): 1}
    u, v = tops.nmg_linear(x, port).chunk(2, dim=-1)
    seq = nmg_fused.act_fn(act)(u) * v
    assert fused.shape == (2, 2, 32) and fused.dtype == dtype
    assert torch.equal(fused, seq)


def test_maybe_fused_ffn_declines(monkeypatch):
    """None (the caller runs the sequential path) for prefill-shaped x, a
    dense weight, and F not a multiple of gr; the routing default can
    switch fusion off, which the counters record."""
    _, (port,) = _weights(FFN_FMT)
    _, (odd,) = _weights(FORMATS[1])          # 2F = 48, gr 16: F = 24
    x = torch.zeros(4, 128)
    tops.reset_kernel_counters()
    assert tops.maybe_fused_ffn(torch.zeros(17, 128), port) is None
    assert tops.maybe_fused_ffn(x, torch.zeros(128, 64)) is None
    assert not tops.fusable_ffn(odd, 24)
    assert tops.maybe_fused_ffn(torch.zeros(4, 64), odd) is None
    assert tops.kernel_counters() == {}
    monkeypatch.setattr(routing, "DEFAULT_FUSED_FFN", False)
    assert tops.maybe_fused_ffn(x, port) is None
    assert tops.kernel_counters() == {("nmg_ffn", "sequential[default]"): 1}


def test_mm_gated_declines_on_promotion_and_inline():
    """``mm_gated`` leaves the gate to the caller when a promotion cast
    would sit between projection and gate, or an inline sparsifier is
    asked for."""
    _, (port,) = _weights(FFN_FMT)
    x = torch.zeros(4, 128, dtype=torch.bfloat16)
    assert mm_gated(x, port, "silu") is None              # f32 weight
    assert mm_gated(x.float(), port, "silu", inline=object()) is None
    assert mm_gated(x.float(), port, "silu").shape == (4, 32)


def test_ffn_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """As for the other wrappers: an operand off the CPU goes to the
    kernel or raises; a meta operand takes the meta route (shape and
    dtype, no launch, never the plain version)."""
    _, (port,) = _weights(FFN_FMT)
    monkeypatch.setattr(nmg_fused, "nmg_ffn_plain",
                        lambda *a, **k: pytest.fail("plain"))
    before = nmg_fused.nmg_ffn.launches
    out = nmg_fused.nmg_ffn(port, torch.empty((128, 4), device="meta"),
                            out_dtype=torch.bfloat16)
    assert (out.device.type, tuple(out.shape), out.dtype) == \
        ("meta", (port.canonical_rows() // 2, 4), torch.bfloat16)
    assert nmg_fused.nmg_ffn.launches == before
    with pytest.raises(ValueError, match="not CUDA"):
        nmg_gemv.check_operands([port], torch.empty((128, 4),
                                                    device="meta"))


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("fmt", ANY_GR, ids=ANY_GR_IDS)
def test_qkv_plain_matches_reference_at_any_gr(fmt):
    """The fused QKV's plain version at gr 1, 3 and 24 against the
    reference's Pallas launch (interpret mode) and its XLA twin, and
    bitwise against three single GEMV calls."""
    M = 5
    refs, ports = _weights(fmt, count=3)
    jb, tb = _b(fmt[5], M)
    got = nmg_fused.nmg_qkv(ports, tb, transpose_out=True)
    want_p = nmg_qkv_pallas(tuple(refs), jb, interpret=True)
    want_x = jops.nmg_qkv_xla(tuple(refs), jb, transpose_out=True)
    for g_, wp, wx, port in zip(got, want_p, want_x, ports):
        np.testing.assert_allclose(g_.numpy(), np.asarray(wp).T, **F32_TOL)
        np.testing.assert_allclose(g_.numpy(), np.asarray(wx), **F32_TOL)
        np.testing.assert_allclose(
            g_.numpy(), nmg_gemv.nmg_gemv(port, tb, transpose_out=True),
            **F32_TOL)


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("fmt", FFN_ANY_GR, ids=["gr1", "gr3", "gr24"])
def test_ffn_plain_matches_reference_at_any_gr(fmt, M):
    """The fused gated FFN's plain version at gr 1, 3 and 24 (the packed
    [128, 48] weight, F = 24 a multiple of each gr) against the
    reference's Pallas kernel (interpret mode) and its XLA twin."""
    (ref,), (port,) = _weights(fmt)
    jb, tb = _b(fmt[5], M)
    assert nmg_fused.fusable_ffn(port, 24)
    got = nmg_fused.nmg_ffn(port, tb)
    assert got.shape == (24, M)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        nmg_ffn_pallas(ref, jb, interpret=True)), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jops.nmg_ffn_xla(ref, jb)), **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gr", [1, 2, 3, 4, 8, 12, 16, 24, 32, 48, 64, 96,
                                128, 130])
def test_row_plan_takes_every_gr(gr, dtype):
    """The CUDA decode bodies' plan: every gr >= 1 gets a body, chosen by
    (gr, M, KN, dtype) alone, so the GEMV, the fused QKV launch and the FFN
    (which call this one function) run the same body at the same gr; the
    ``tc`` body's tile never spans two fiber groups, its K parts are one
    cluster (at most eight) and cover K; the grid covers every row."""
    assert nmg_fused.row_plan is nmg_gemv.row_plan
    for M in (1, 4, 8, 9, 16, 40):
        for KN in (1, 60, 192, 640, 1728, 6144):
            p = nmg_gemv.row_plan(gr, M, KN, dtype)
            assert p == nmg_gemv.row_plan(gr, M, KN, dtype)
            want = ("tc" if dtype == torch.bfloat16 and gr % 16 == 0 else
                    "rows" if dtype == torch.float32 and gr % 4 == 0 else
                    "general")
            assert p.body == want
            if p.body == "tc":
                assert gr % p.rows == 0 and p.rows in (16, 32, 64)
                assert p.nt8 == (1 if min(M, 16) <= 8 else 2)
                nslab = -(-KN // 64)
                assert 1 <= p.parts <= 8 and -(-nslab // p.per) == p.parts
                assert (p.parts - 1) * p.per < nslab <= p.parts * p.per
            else:
                assert p.rows == 4 and p.parts == 1
            for R in (gr, 3 * gr + 1, 2560):
                gx, gy, gz = p.grid(R, nseg=3, N=M)
                assert gx * p.rows >= R * p.parts and (gy, gz) == (
                    3, -(-M // 16))
    with pytest.raises(ValueError):
        nmg_gemv.row_plan(0, 4, 64, dtype)


def test_chunk_geometry():
    """cs stored values of a row lie in cx consecutive rows of B: the
    window the ``tc`` body stages for each K part."""
    _, (port,) = _weights(FORMATS[0])
    cs, cx = nmg_gemv.chunk_geometry(port)
    assert (cs, cx) == (32, 128)
    cols = port.gather_plan().cols.reshape(port.gather_plan().cols.shape[0],
                                           -1, cs)
    lo = torch.arange(cols.shape[1])[None, :, None] * cx
    assert bool(((cols >= lo) & (cols < lo + cx)).all())
