"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX nor
``repro``, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 accumulation in both versions, bf16 inputs converted
exactly, so only the order of the f32 sums differs.  With unit-variance
inputs an output sums up to 768 stored products into partial sums of
size ~30, so a reordering moves it by a few units of 2**-24 * 30 per
term: atol = 2e-4, rtol = 1e-5 (the card showed 3.5e-5 at K = 3072).
Fused QKV against three single launches: bitwise.  ``nm_mask`` against
its plain version: bitwise (the same rank rule on the same values), through
each of its three bodies (``vector``, ``staged``, ``long``), whose choice
is asserted where a test means one.
``matmul_threshold``: f32 values within rtol = atol = 1e-5 on inputs
scaled so y ~ N(0, 1), the mask equal except where |y| lies within 1e-5
of the threshold (another summation order than cuBLAS), and its backward
equal to the reference's cotangent formula on the kernel's own mask.
The tensor-core bodies (bf16 SpMM and ``matmul_threshold``) keep these
tolerances: bf16 products are exact in f32 and the mma sums them in f32,
so again only the order of the sums differs.  Each redesigned kernel is
also held bitwise against a second launch on the same inputs (its
summation order is fixed by the shape), and the SpMM's cast and
transposed epilogue bitwise against ``.to(dtype).T`` of its f32 output.
The fused gated FFN against the GEMV followed by PyTorch's own
activation and multiply: bitwise for silu (the kernel's epilogue replays
PyTorch's CUDA silu); for gelu's tanh approximation within one rounding
step of the output type (``tanhf`` and the polynomial may round
differently from PyTorch's kernel).  The decode bodies (``tc`` for bf16
at gr a multiple of 16, ``rows`` for f32 at gr a multiple of 4,
``general`` otherwise) keep these tolerances and contracts at every gr,
and the SpMM takes every gr (gr not a multiple of 64 through the GEMV
kernel over 16-column chunks)."""

import functools

import pytest
import torch

from repro_torch.core.nmg import dense_to_grouped_nm
from repro_torch.kernels import fused_sparse_matmul, nm_mask, nmg_fused, \
    nmg_gemv, nmg_spmm
from repro_torch.kernels.nmg_gemv import row_plan

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=2e-4)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false); runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _weights(K, R, dtype, count=1, seed=0, gr=64):
    g = torch.Generator().manual_seed(seed)
    return [dense_to_grouped_nm(torch.randn(K, R, generator=g), 1, 4, 8,
                                gr=gr, sparse_dim=0).to("cuda", dtype)
            for _ in range(count)]


@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemv_and_fused_qkv_match_plain(dtype, M):
    _require_cuda()
    ws = _weights(768, 768, dtype, count=3)
    x = torch.randn(M, 768, device="cuda").to(dtype)
    for w in ws:
        for t in (False, True):
            got = nmg_gemv.nmg_gemv(w, x.T, transpose_out=t)
            want = nmg_gemv.nmg_gemv_plain(w, x.T, transpose_out=t)
            torch.testing.assert_close(got, want, **TOL)
    fused = nmg_fused.nmg_qkv(ws, x.T, out_dtype=dtype, transpose_out=True)
    for f, w in zip(fused, ws):
        assert torch.equal(f, nmg_gemv.nmg_gemv(w, x.T, out_dtype=dtype,
                                                transpose_out=True))


@pytest.mark.parametrize("K,R", [(768, 3072), (3072, 768), (200, 192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemv_shapes_and_padding(dtype, K, R):
    """K not a multiple of the chunk extent (200) reads padded rows as 0."""
    _require_cuda()
    (w,) = _weights(K, R, dtype)
    b = torch.randn(K, 4, device="cuda").to(dtype)   # contiguous B too
    torch.testing.assert_close(nmg_gemv.nmg_gemv(w, b),
                               nmg_gemv.nmg_gemv_plain(w, b), **TOL)


@pytest.mark.parametrize("N", [17, 64, 130])
@pytest.mark.parametrize("K,R", [(768, 3072), (3072, 768), (768, 768),
                                 (200, 192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_matches_plain(dtype, K, R, N):
    _require_cuda()
    (w,) = _weights(K, R, dtype)
    x = torch.randn(N, K, device="cuda").to(dtype)
    got = nmg_spmm.nmg_spmm(w, x.T)
    assert got.dtype == torch.float32 and got.shape == (R, N)
    torch.testing.assert_close(got, nmg_spmm.nmg_spmm_plain(w, x.T),
                               **TOL)


#: qwen1.5-4b's n:m:g projections as [K, R] weights: the packed gated
#: ``wi``, ``mlp.wo`` and ``attn.wq``
QWEN = {"wi": (2560, 13824), "wo": (6912, 2560), "wq": (2560, 2560)}
_QWEN_CACHE: dict = {}


def _qwen_weight(name, gr, dtype):
    """A qwen1.5-4b projection at 1:4:8, converted on the card from a
    seeded fan-in-scaled draw (outputs ~ N(0, 1), the scale the stated
    tolerances assume), cached across cases."""
    key = (name, gr, dtype)
    if key not in _QWEN_CACHE:
        K, R = QWEN[name]
        g = torch.Generator(device="cuda").manual_seed(len(_QWEN_CACHE))
        dense = torch.randn(K, R, generator=g, device="cuda") / K ** 0.5
        _QWEN_CACHE[key] = dense_to_grouped_nm(
            dense.to(dtype), 1, 4, 8, gr=gr, sparse_dim=0)
    return _QWEN_CACHE[key]


@pytest.mark.parametrize("N", [17, 24, 32, 64, 130])
@pytest.mark.parametrize("gr", [64, 128])
@pytest.mark.parametrize("name", sorted(QWEN))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_qwen_shapes(dtype, name, gr, N):
    """At qwen1.5-4b's widths: against the plain version, bitwise against
    a second launch, and the cast / transposed epilogue bitwise against
    ``.to(dtype).T`` of the f32 output."""
    _require_cuda()
    w = _qwen_weight(name, gr, dtype)
    K, R = QWEN[name]
    g = torch.Generator(device="cuda").manual_seed(N)
    x = torch.randn(N, K, generator=g, device="cuda").to(dtype)
    got = nmg_spmm.nmg_spmm(w, x.T)
    assert got.dtype == torch.float32 and got.shape == (R, N)
    torch.testing.assert_close(got, nmg_spmm.nmg_spmm_plain(w, x.T), **TOL)
    assert torch.equal(got, nmg_spmm.nmg_spmm(w, x.T))
    yt = nmg_spmm.nmg_spmm(w, x.T, out_dtype=dtype, transpose_out=True)
    assert yt.dtype == dtype and yt.shape == (N, R) and yt.is_contiguous()
    assert torch.equal(yt, got.to(dtype).T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_reads_contiguous_b(dtype):
    """B as a contiguous [K, N] takes the generic strided gather."""
    _require_cuda()
    (w,) = _weights(768, 768, dtype)
    b = torch.randn(768, 40, device="cuda").to(dtype)
    torch.testing.assert_close(nmg_spmm.nmg_spmm(w, b),
                               nmg_spmm.nmg_spmm_plain(w, b), **TOL)


@pytest.mark.parametrize("K,n,m,kn", [(100, 2, 4, 60), (18, 1, 3, 6),
                                      (27, 1, 3, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_val_rows_not_16_byte_aligned(dtype, K, n, m, kn):
    """Rows of ``val`` of 60, 6 and 9 stored values (8-, 4- and 2-byte
    copies in the bf16 body), each a single ragged slab."""
    _require_cuda()
    g = torch.Generator().manual_seed(K)
    w = dense_to_grouped_nm(torch.randn(K, 192, generator=g), n, m, 1,
                            gr=64, sparse_dim=0).to("cuda", dtype)
    assert w.val.shape[1] * w.val.shape[2] == kn
    x = torch.randn(33, K, device="cuda").to(dtype)
    torch.testing.assert_close(nmg_spmm.nmg_spmm(w, x.T),
                               nmg_spmm.nmg_spmm_plain(w, x.T), **TOL)


@pytest.mark.parametrize("K,n,m,g", [(1024, 1, 8, 4), (96, 2, 4, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_staged_window_and_the_cols_outside_it(dtype, K, n, m, g):
    """B = x.T with 16-byte aligned rows (the bf16 body's staged window):
    at 1:8:4 a 64-value slab spans two 256-row chunks, so half of its
    cols fall outside the window and are read from device memory; at
    2:4:2 the slabs start inside a chunk."""
    _require_cuda()
    gen = torch.Generator().manual_seed(K)
    w = dense_to_grouped_nm(torch.randn(K, 192, generator=gen), n, m, g,
                            gr=64, sparse_dim=0).to("cuda", dtype)
    x = torch.randn(40, K, device="cuda").to(dtype)
    torch.testing.assert_close(nmg_spmm.nmg_spmm(w, x.T),
                               nmg_spmm.nmg_spmm_plain(w, x.T), **TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _require_cuda()
    (w,) = _weights(768, 768, torch.bfloat16)
    with pytest.raises(ValueError):
        nmg_gemv.nmg_gemv(w, torch.randn(768, 17, device="cuda",
                                         dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        nmg_gemv.nmg_gemv(w, torch.randn(768, 4, device="cuda"))  # f32 B
    # gr16 (a multiple of 16, not of 64) is computed: test_spmm_any_gr
    w16 = dense_to_grouped_nm(torch.randn(768, 64), 1, 4, 8, gr=16,
                              sparse_dim=0).to("cuda", torch.bfloat16)
    b = torch.randn(768, 32, device="cuda", dtype=torch.bfloat16)
    torch.testing.assert_close(nmg_spmm.nmg_spmm(w16, b),
                               nmg_spmm.nmg_spmm_plain(w16, b), **TOL)


def _packed(K, F, dtype, seed=0):
    """A packed gated-MLP weight [K, 2F] at 1:4:8 gr64 on the card."""
    (w,) = _weights(K, 2 * F, dtype, seed=seed)
    return w


@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_matches_plain_and_sequential(dtype, act, M):
    _require_cuda()
    w = _packed(512, 384, dtype)
    x = torch.randn(M, 512, device="cuda").to(dtype)
    for t in (False, True):
        got = nmg_fused.nmg_ffn(w, x.T, act=act, transpose_out=t)
        assert got.dtype == torch.float32
        assert got.shape == ((M, 384) if t else (384, M))
        torch.testing.assert_close(
            got, nmg_fused.nmg_ffn_plain(w, x.T, act=act, transpose_out=t),
            **TOL)
    fused = nmg_fused.nmg_ffn(w, x.T, act=act, out_dtype=dtype,
                              transpose_out=True)
    u, v = nmg_gemv.nmg_gemv(w, x.T, out_dtype=dtype,
                             transpose_out=True).chunk(2, dim=-1)
    seq = nmg_fused.act_fn(act)(u) * v
    if act == "silu":
        assert torch.equal(fused, seq)
    else:
        torch.testing.assert_close(
            fused.float(), seq.float(), atol=1e-6,
            rtol=2 ** -7 if dtype == torch.bfloat16 else 1e-6)


def test_ffn_wrapper_rejects_what_the_kernel_does_not_take():
    _require_cuda()
    bf16 = torch.bfloat16
    w = _packed(512, 384, bf16)
    with pytest.raises(ValueError, match="not CUDA"):
        nmg_fused.nmg_ffn(w, torch.randn(512, 4, dtype=bf16))
    with pytest.raises(ValueError, match="1..16"):
        nmg_fused.nmg_ffn(w, torch.randn(512, 17, device="cuda", dtype=bf16))
    odd = _packed(512, 96, bf16)        # F = 96 is not a multiple of gr = 64
    with pytest.raises(ValueError, match="not fusable"):
        nmg_fused.nmg_ffn(odd, torch.randn(512, 4, device="cuda", dtype=bf16))


NM_CASES = [(1, 4), (2, 4), (2, 8), (3, 6), (1, 10), (2, 16)]


@pytest.mark.parametrize("shape", [(32, 64), (7, 130), (256, 520),
                                   (36864, 768)])
@pytest.mark.parametrize("n,m", NM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_mask_equals_plain(dtype, n, m, shape):
    """Bitwise, at the reference's test shapes and at the stacked
    ``mlp.wo`` of full-width bert-base-sten ([12 * 3072, 768])."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    got = nm_mask.nm_mask(x, n, m)
    assert got.dtype == torch.bool and got.shape == x.shape
    assert torch.equal(got, nm_mask.nm_mask_plain(x, n, m))


@pytest.mark.parametrize("n,m", NM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_mask_ties_and_ragged_blocks(dtype, n, m):
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(-2, 3, (3, 16, 131), generator=g,
                      device="cuda").to(dtype)
    x[0, 0] = 1.5
    x[0, 1] = 0
    x[1, 2, -7:] = 0
    assert torch.equal(nm_mask.nm_mask(x, n, m),
                       nm_mask.nm_mask_plain(x, n, m))


def _mt_operands(M, K, N, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(M, K, generator=g, device="cuda").to(dtype)
    b = (torch.randn(K, N, generator=g, device="cuda") / K ** 0.5).to(dtype)
    return a, b


def _check_mask(mask, want_mask, a, b, t):
    y = a.double() @ b.double()
    diff = mask != want_mask
    near = ((y.abs() - t).abs() <= 1e-5 * max(1.0, t))
    assert not (diff & ~near).any(), "mask differs off the boundary"
    return diff


@pytest.mark.parametrize("shape", [(32, 48, 40), (64, 64, 64), (33, 70, 9),
                                   (130, 200, 129), (1024, 768, 3072)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_threshold_matches_plain(dtype, shape):
    _require_cuda()
    a, b = _mt_operands(*shape, dtype)
    for t in (0.5, 2.0):
        val, mask = fused_sparse_matmul.matmul_threshold(a, b, t)
        assert val.dtype == torch.float32 and mask.dtype == torch.bool
        pv, pm = fused_sparse_matmul.matmul_threshold_plain(a, b, t)
        diff = _check_mask(mask, pm, a, b, t)
        torch.testing.assert_close(val[~diff], pv[~diff], rtol=1e-5,
                                   atol=1e-5)
        # masked entries are zeros carrying y's sign, as y * mask gives
        y = (a.double() @ b.double())[~mask]
        dropped = val[~mask]
        assert (dropped == 0).all()
        clear = y.abs() > 1e-3
        assert torch.equal(torch.signbit(dropped)[clear], (y < 0)[clear])


def test_matmul_threshold_reads_strided_operands():
    """A transposed (non-contiguous) operand is read through its strides."""
    _require_cuda()
    a, b = _mt_operands(96, 80, 72, torch.bfloat16)
    bt = b.T.contiguous().T
    got = fused_sparse_matmul.matmul_threshold(a, bt, 0.5)
    want = fused_sparse_matmul.matmul_threshold(a, b, 0.5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shape", [(129, 71, 193), (1000, 770, 3000),
                                   (1023, 767, 3071)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_threshold_off_tile_and_unaligned_rows(dtype, shape):
    """M, N and K off every tile multiple (128 x 192 x 32 and 128 x 128 x
    16), then operands whose rows are not 16 bytes apart nor 16-byte
    aligned (column slices of wider tensors): against the plain version
    as above, and bitwise against a second launch."""
    _require_cuda()
    M, K, N = shape
    a, b = _mt_operands(M, K, N, dtype)
    a_odd = torch.empty(M, K + 5, device="cuda", dtype=dtype)[:, 3:K + 3]
    b_odd = torch.empty(K, N + 3, device="cuda", dtype=dtype)[:, 1:N + 1]
    a_odd.copy_(a)
    b_odd.copy_(b)
    assert a_odd.stride(0) % 8 != 0 and b_odd.stride(0) % 8 != 0
    for x, y in ((a, b), (a_odd, b_odd)):
        val, mask = fused_sparse_matmul.matmul_threshold(x, y, 0.5)
        pv, pm = fused_sparse_matmul.matmul_threshold_plain(x, y, 0.5)
        diff = _check_mask(mask, pm, a, b, 0.5)
        torch.testing.assert_close(val[~diff], pv[~diff], rtol=1e-5,
                                   atol=1e-5)
        again = fused_sparse_matmul.matmul_threshold(x, y, 0.5)
        assert torch.equal(val, again[0]) and torch.equal(mask, again[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_threshold_backward_on_the_card(dtype):
    """The autograd function's gradients are the reference's cotangents
    on the kernel's mask: da = (g*mask) @ b^T, db = a^T @ (g*mask)."""
    _require_cuda()
    a, b = _mt_operands(256, 192, 320, dtype)
    a.requires_grad_(True)
    b.requires_grad_(True)
    r = torch.randn(256, 320, device="cuda")
    val, mask = fused_sparse_matmul.matmul_threshold(a, b, 0.5)
    (val * r).sum().backward()
    gm = r * mask
    assert torch.equal(a.grad, (gm @ b.detach().float().T).to(dtype))
    assert torch.equal(b.grad, (a.detach().float().T @ gm).to(dtype))


def test_training_kernel_wrappers_reject_what_they_do_not_take():
    _require_cuda()
    x = torch.randn(8, 32, device="cuda")
    # m = 17 is computed: test_nm_mask_wide_blocks
    assert torch.equal(nm_mask.nm_mask(x, 2, 17),
                       nm_mask.nm_mask_plain(x, 2, 17))
    with pytest.raises(ValueError):
        nm_mask.nm_mask(x, 3, 2)
    with pytest.raises(ValueError):
        nm_mask.nm_mask(x.half(), 2, 4)
    with pytest.raises(ValueError):
        fused_sparse_matmul.matmul_threshold(x, torch.randn(
            32, 4, device="cuda", dtype=torch.bfloat16), 0.5)
    with pytest.raises(ValueError):
        fused_sparse_matmul.matmul_threshold(x, torch.randn(16, 4,
                                                            device="cuda"), 0.5)
    with pytest.raises(ValueError):
        fused_sparse_matmul.matmul_threshold(x, torch.randn(32, 4), 0.5)


# ---------------------------------------------------------------------------
# every gr and every m the reference takes
# ---------------------------------------------------------------------------

#: tc body (16, 32, 64, 128), general body (1, 3, 24 for bf16; all of
#: 1, 3 in f32), rows body (f32 at 16..128 and 24)
ANY_GR = [1, 3, 16, 24, 32, 64, 128]


@pytest.mark.parametrize("M", [1, 4, 9, 16])
@pytest.mark.parametrize("gr", ANY_GR)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_bodies_at_any_gr(dtype, gr, M):
    """The GEMV, fused QKV and FFN at every gr: against the plain versions,
    fused QKV bitwise three GEMV launches, the FFN bitwise the GEMV
    followed by silu and multiply, and each bitwise on a relaunch.  K = 520
    leaves a ragged last slab; F = 384 is a multiple of every gr here."""
    _require_cuda()
    K, F = 520, 384
    (w,) = _weights(K, 2 * F, dtype, gr=gr, seed=gr)
    qkv = _weights(K, 200, dtype, count=3, gr=gr, seed=gr + 1)
    g = torch.Generator(device="cuda").manual_seed(M)
    x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
    KN = w.val.shape[1] * w.val.shape[2]
    body = row_plan(gr, M, KN, dtype).body
    assert body == ("tc" if dtype == torch.bfloat16 and gr % 16 == 0 else
                    "rows" if dtype == torch.float32 and gr % 4 == 0 else
                    "general")
    for t in (False, True):
        torch.testing.assert_close(
            nmg_gemv.nmg_gemv(w, x.T, transpose_out=t),
            nmg_gemv.nmg_gemv_plain(w, x.T, transpose_out=t), **TOL)
        torch.testing.assert_close(
            nmg_fused.nmg_ffn(w, x.T, transpose_out=t),
            nmg_fused.nmg_ffn_plain(w, x.T, transpose_out=t), **TOL)
    for got, want in zip(nmg_fused.nmg_qkv(qkv, x.T, transpose_out=True),
                         nmg_fused.nmg_qkv_plain(qkv, x.T,
                                                 transpose_out=True)):
        torch.testing.assert_close(got, want, **TOL)
    y = nmg_gemv.nmg_gemv(w, x.T, out_dtype=dtype, transpose_out=True)
    assert torch.equal(y, nmg_gemv.nmg_gemv(w, x.T, out_dtype=dtype,
                                            transpose_out=True))
    fused = nmg_fused.nmg_qkv(qkv, x.T, out_dtype=dtype, transpose_out=True)
    for f, wq in zip(fused, qkv):
        assert torch.equal(f, nmg_gemv.nmg_gemv(wq, x.T, out_dtype=dtype,
                                                transpose_out=True))
    again = nmg_fused.nmg_qkv(qkv, x.T, out_dtype=dtype, transpose_out=True)
    assert all(torch.equal(a, f) for a, f in zip(again, fused))
    ffn = nmg_fused.nmg_ffn(w, x.T, out_dtype=dtype, transpose_out=True)
    u, v = y.chunk(2, dim=-1)
    assert torch.equal(ffn, torch.nn.functional.silu(u) * v)
    assert torch.equal(ffn, nmg_fused.nmg_ffn(w, x.T, out_dtype=dtype,
                                              transpose_out=True))


@pytest.mark.parametrize("M", [1, 4, 8, 16])
@pytest.mark.parametrize("gr", [16, 32, 64, 128])
@pytest.mark.parametrize("name", ["wi", "wo", "wq"])
def test_tc_body_at_qwen_shapes(name, gr, M):
    """The bf16 ``tc`` body at qwen1.5-4b's widths (the packed ``wi`` also
    through the FFN): against the plain versions, the bitwise contracts
    and a relaunch."""
    _require_cuda()
    bf16 = torch.bfloat16
    w = _qwen_weight(name, gr, bf16)
    K, R = QWEN[name]
    assert row_plan(gr, M, w.val.shape[1] * w.val.shape[2], bf16).body == "tc"
    g = torch.Generator(device="cuda").manual_seed(M)
    x = torch.randn(M, K, generator=g, device="cuda").to(bf16)
    torch.testing.assert_close(
        nmg_gemv.nmg_gemv(w, x.T, transpose_out=True),
        nmg_gemv.nmg_gemv_plain(w, x.T, transpose_out=True), **TOL)
    y = nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16, transpose_out=True)
    assert torch.equal(y, nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16,
                                            transpose_out=True))
    if name == "wq":
        qkv = [w, _qwen_weight("wq", gr, torch.float32).to(dtype=bf16), w]
        fused = nmg_fused.nmg_qkv(qkv, x.T, out_dtype=bf16,
                                  transpose_out=True)
        for f, wq in zip(fused, qkv):
            assert torch.equal(f, nmg_gemv.nmg_gemv(
                wq, x.T, out_dtype=bf16, transpose_out=True))
    if name == "wi":
        torch.testing.assert_close(
            nmg_fused.nmg_ffn(w, x.T, transpose_out=True),
            nmg_fused.nmg_ffn_plain(w, x.T, transpose_out=True), **TOL)
        ffn = nmg_fused.nmg_ffn(w, x.T, out_dtype=bf16, transpose_out=True)
        u, v = y.chunk(2, dim=-1)
        assert torch.equal(ffn, torch.nn.functional.silu(u) * v)
        assert torch.equal(ffn, nmg_fused.nmg_ffn(w, x.T, out_dtype=bf16,
                                                  transpose_out=True))


@pytest.mark.parametrize("N", [17, 32, 40])
@pytest.mark.parametrize("gr", [1, 3, 16, 24, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_any_gr(dtype, gr, N):
    """gr not a multiple of 64 goes through the GEMV kernel over 16-column
    chunks: against the plain version, bitwise on a relaunch, and the cast
    [N, R] epilogue bitwise ``.to(dtype).T`` of the f32 output."""
    _require_cuda()
    (w,) = _weights(768, 768, dtype, gr=gr, seed=gr)
    g = torch.Generator(device="cuda").manual_seed(N)
    x = torch.randn(N, 768, generator=g, device="cuda").to(dtype)
    before = nmg_spmm.nmg_spmm.launches
    got = nmg_spmm.nmg_spmm(w, x.T)
    assert nmg_spmm.nmg_spmm.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (768, N)
    torch.testing.assert_close(got, nmg_spmm.nmg_spmm_plain(w, x.T), **TOL)
    assert torch.equal(got, nmg_spmm.nmg_spmm(w, x.T))
    yt = nmg_spmm.nmg_spmm(w, x.T, out_dtype=dtype, transpose_out=True)
    assert yt.shape == (N, 768) and yt.is_contiguous()
    assert torch.equal(yt, got.to(dtype).T)


@pytest.mark.parametrize("n,m", [(2, 17), (5, 20), (16, 32), (1, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_mask_wide_blocks(dtype, n, m):
    """m above the register array: bitwise against the plain version on
    the stacked bert-base-sten ``mlp.wo`` (ragged where m does not divide
    768) and on small integers full of ties."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn(12 * 3072, 768, generator=g, device="cuda").to(dtype)
    assert torch.equal(nm_mask.nm_mask(x, n, m),
                       nm_mask.nm_mask_plain(x, n, m))
    t = torch.randint(-2, 3, (3, 16, 131), generator=g,
                      device="cuda").to(dtype)
    t[1, 2, -7:] = 0
    assert torch.equal(nm_mask.nm_mask(t, n, m),
                       nm_mask.nm_mask_plain(t, n, m))


#: the templated m of nm_mask's vector body
VECTOR_M = (2, 4, 8, 16, 32)
#: magnitudes at the edges of the rank rule: signed zeros, subnormals (rank
#: as 0), the smallest normal, infinities, NaN and a few ordinary values
SPECIAL = (0.0, -0.0, 1e-40, -1e-40, 2e-39, -2e-39, 1.1754943508222875e-38,
           float("inf"), float("-inf"), float("nan"), 1.0, -0.5, 2.0)


def _special(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    vals = torch.tensor(SPECIAL)
    p = torch.ones(len(SPECIAL))
    p[:6] = 4.0                          # mostly zeros and subnormals
    idx = torch.multinomial(p, shape[0] * shape[1], replacement=True,
                            generator=g)
    return vals[idx].reshape(shape).to("cuda", dtype)


def _check_nm(x, n, m, body=None):
    if body is not None:
        assert nm_mask.nm_mask_plan(x, n, m)["body"] == body
    got = nm_mask.nm_mask(x, n, m)
    assert got.dtype == torch.bool and got.shape == x.shape
    assert torch.equal(got, nm_mask.nm_mask_plain(x, n, m)), (n, m, x.shape)


@pytest.mark.parametrize("M", VECTOR_M)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_mask_vector_body_every_n(dtype, M):
    """Every n in 0..M through the vector body (whole, aligned rows), on
    normal values and on small integers full of ties, bitwise."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(M)
    x = torch.randn(257, 256, generator=g, device="cuda").to(dtype)
    t = torch.randint(-2, 3, (65, 256), generator=g, device="cuda").to(dtype)
    for n in range(M + 1):
        _check_nm(x, n, M, "vector")
        _check_nm(t, n, M, "vector")


@pytest.mark.parametrize("n,m", [(1, 4), (2, 4), (2, 8), (3, 6), (1, 10),
                                 (5, 20), (16, 32), (0, 4), (4, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_mask_special_values(dtype, n, m):
    """The CPU test's special-value blocks (subnormals rank as 0, NaN kept
    and never counted, ties to the lowest index) through every body that
    takes them: whole aligned rows, a ragged last block, a misaligned
    view."""
    _require_cuda()
    x = _special((64, 256), dtype, 7 * m + n)
    _check_nm(x, n, m, "vector" if m in VECTOR_M else "staged")
    _check_nm(_special((16, 2 * m + 3), dtype, m), n, m, "staged")
    flat = _special((1, 64 * 256 + 1), dtype, n).reshape(-1)
    _check_nm(flat[1:].view(64, 256), n, m, "staged")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_mask_unaligned_rows_and_views(dtype):
    """Rows whose pitch is not a multiple of 16 bytes (K % 8 != 0: K = 100
    in bf16, K = 6 in both), a view that starts one element into its
    storage (``big[1:]`` of [R, 7], and the stacked ``mlp.wo`` shape one
    element off), all through the staged body, bitwise; f32 rows of 100
    (400 bytes) are aligned and take the vector body."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = torch.randn(300, 100, generator=g, device="cuda").to(dtype)
    _check_nm(rows, 2, 4, "staged" if dtype == torch.bfloat16 else "vector")
    _check_nm(torch.randn(300, 6, generator=g, device="cuda").to(dtype), 1,
              2, "staged")
    big = torch.randn(4097, 7, generator=g, device="cuda").to(dtype)
    _check_nm(big[1:], 2, 4, "staged")
    _check_nm(big[1:], 3, 7, "staged")
    flat = torch.randn(12 * 3072 * 768 + 1, generator=g,
                       device="cuda").to(dtype)
    for n, m in ((2, 4), (16, 32), (5, 20)):
        _check_nm(flat[1:].view(12 * 3072, 768), n, m, "staged")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_mask_long_blocks(dtype):
    """m past the staged tile (the long body): whole and ragged blocks,
    bitwise."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(2, 6000, generator=g, device="cuda").to(dtype)
    _check_nm(x, 100, 6000, "long")
    x = torch.randint(-3, 4, (3, 9000), generator=g, device="cuda").to(dtype)
    _check_nm(x, 3000, 6000, "long")


def test_nm_mask_past_2_31_elements():
    """One operand of more than 2**31 elements ([2**21 + 3, 1024] bf16,
    ~4.3 GB) through the vector (2:4) and staged (5:20, ragged) bodies,
    held against the plain version in row chunks."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(8)
    R = 2 ** 21 + 3
    x = torch.empty(R, 1024, device="cuda", dtype=torch.bfloat16)
    for r0 in range(0, R, 2 ** 18):
        x[r0:r0 + 2 ** 18] = torch.randn(x[r0:r0 + 2 ** 18].shape,
                                         generator=g, device="cuda")
    assert x.numel() > 2 ** 31
    for (n, m), body in (((2, 4), "vector"), ((5, 20), "staged")):
        assert nm_mask.nm_mask_plan(x, n, m)["body"] == body
        got = nm_mask.nm_mask(x, n, m)
        for r0 in range(0, R, 2 ** 16):
            assert torch.equal(got[r0:r0 + 2 ** 16], nm_mask.nm_mask_plain(
                x[r0:r0 + 2 ** 16], n, m)), (n, m, r0)
        del got


def test_nmg_linear_prefill_at_gr16_on_the_card():
    """The path the gr16 refusal broke: a prefill-shaped x through
    ``nmg_linear`` with a gr16 weight, against the plain version."""
    _require_cuda()
    from repro_torch.kernels import ops

    (w,) = _weights(768, 768, torch.bfloat16, gr=16)
    x = torch.randn(2, 20, 768, device="cuda").to(torch.bfloat16)
    ops.reset_kernel_counters()
    y = ops.nmg_linear(x, w)
    assert ops.kernel_counters()[("nmg_spmm", "cuda")] == 1
    want = nmg_spmm.nmg_spmm_plain(w, x.reshape(-1, 768).T,
                                   out_dtype=torch.bfloat16,
                                   transpose_out=True)
    # the same body and cast as the direct call, so the same bits
    assert torch.equal(y.reshape(-1, 768), nmg_spmm.nmg_spmm(
        w, x.reshape(-1, 768).T, out_dtype=torch.bfloat16,
        transpose_out=True))
    torch.testing.assert_close(y.reshape(-1, 768).float(), want.float(),
                               rtol=2 ** -7, atol=1e-3)


# ---------------------------------------------------------------------------
# the engine's decode programs replayed as CUDA graphs (serve/graphs.py)
# ---------------------------------------------------------------------------


def _served(arch):
    """The SMOKE config of ``arch`` (bf16) with seeded weights on the card,
    n:m:g 1:4:8 gr16 with ``attn=True`` (the ``tc`` decode body; qwen's
    gated MLP through the fused FFN)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_lm
    from repro_torch.serve import sparsify_for_serving

    cfg = get_smoke(arch)
    params = init_lm(cfg, seed=0, device="cuda")
    return cfg, sparsify_for_serving(params, 1, 4, 8, gr=16, attn=True)


@pytest.mark.parametrize("arch", ["bert-base-sten", "qwen1.5-4b"])
def test_decode_graphs_replay_bitwise_eager(arch):
    """Three chunks with an admission after the first (the first run is
    eager, then captured; the others replay) and two single steps, each
    against the eager program on a clone of the cache: tokens, logits and
    caches bitwise equal, and the launch counters of a replay equal those
    of the eager run.  The model's ``tag`` sites run here with no sparsity
    plan active (each returns its input itself)."""
    _require_cuda()
    from repro_torch.core.builder import _active

    assert _active() is None
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, prefill_into_slot
    from repro_torch.serve.engine import _decode_chunk_fn, _decode_fn
    from repro_torch.serve.graphs import DecodeGraph

    cfg, params = _served(arch)
    B, T = 4, 4
    gen = torch.Generator(device="cuda").manual_seed(1)

    def prompt(n):
        return torch.randint(0, cfg.vocab, (1, n), device="cuda",
                             generator=gen, dtype=torch.int32)

    cache = init_cache(cfg, B, 40, device="cuda")
    for slot, n in enumerate((9, 17, 5)):        # slot 3 stays free
        prefill_into_slot(params, cfg, prompt(n), cache, slot)
    ref = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    pool = torch.cuda.graph_pool_handle()
    chunk = DecodeGraph(_decode_chunk_fn(cfg, T), params, cache, B,
                        pool=pool)
    step = DecodeGraph(_decode_fn(cfg), params, cache, B, pool=pool)
    tok = np.array([3, 7, 11, 0], np.int32)
    pos = np.array([9, 17, 5, 0], np.int32)

    def eager(fn):
        ops.reset_kernel_counters()
        out = fn(params, torch.as_tensor(tok[:, None], device="cuda"), ref,
                 torch.as_tensor(pos, device="cuda"))
        return out, ops.counter_snapshot()

    for turn in range(3):
        ops.reset_kernel_counters()
        got = chunk.run(tok, pos).clone()
        replayed = ops.counter_snapshot()
        want, counts = eager(_decode_chunk_fn(cfg, T))
        assert torch.equal(got, want), turn
        for k in ("k", "v"):
            assert torch.equal(cache[k], ref[k]), (turn, k)
        assert replayed == counts, turn
        assert counts["launches"]["nmg_qkv"] == T * cfg.n_layers
        tok, pos = got[-1].cpu().numpy().copy(), pos + T
        if turn == 0:                           # admission into slot 3
            p = prompt(6)
            for c in (cache, ref):
                prefill_into_slot(params, cfg, p, c, 3)
            tok[3], pos[3] = 1, 6
    assert chunk.info["captured"] and chunk.info["replays"] == 2
    for turn in range(2):
        ops.reset_kernel_counters()
        got = step.run(tok, pos).clone()
        replayed = ops.counter_snapshot()
        want, counts = eager(_decode_fn(cfg))
        assert torch.equal(got, want), turn
        for k in ("k", "v"):
            assert torch.equal(cache[k], ref[k]), (turn, k)
        assert replayed == counts, turn
        tok, pos = got.argmax(-1).int().cpu().numpy(), pos + 1
    assert step.info["replays"] == 1
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    if cfg.gated_mlp:
        assert counts["launches"]["nmg_ffn"] == cfg.n_layers


@functools.lru_cache(maxsize=None)
def _bert_full(fmt):
    """Full-width bert-base-sten (12 layers, d_model 768, bf16) with
    seeded weights on the card: dense, or n:m:g 1:4:8 with ``attn=True``
    at gr64 (prefill through the SpMM kernel above 16 tokens) or gr16 (the
    SpMM route through the GEMV kernel in 16-column chunks)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.serve import sparsify_for_serving

    cfg = get_config("bert-base-sten")
    params = init_lm(cfg, seed=0, device="cuda")
    if fmt == "dense":
        return cfg, params
    return cfg, sparsify_for_serving(params, 1, 4, 8, gr=int(fmt[2:]),
                                     attn=True)


@pytest.mark.parametrize("S", [16, 24, 32, 64])
@pytest.mark.parametrize("fmt", ["dense", "gr64", "gr16"])
def test_prefill_graph_replay_bitwise_eager(fmt, S):
    """One admission program at full bert width: the first run (eager on
    the capture stream, then captured) and two replays, into slots 1, 3
    and 0 at offsets 0, 5 and 40, each against eager ``prefill_into_slot``
    on a clone of the cache: logits and caches bitwise equal, the launch
    counts of each run equal to the eager run's, the storage kept."""
    _require_cuda()
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, prefill_into_slot
    from repro_torch.serve.cache import _slot_prefill_fn
    from repro_torch.serve.graphs import PrefillGraph

    cfg, params = _bert_full(fmt)
    gen = torch.Generator(device="cuda").manual_seed(S)
    cache = init_cache(cfg, 4, 96, device="cuda")
    ref = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    g = PrefillGraph(_slot_prefill_fn(cfg), params, cache, S,
                     pool=torch.cuda.graph_pool_handle())
    for turn, (slot, off) in enumerate(((1, 0), (3, 5), (0, 40))):
        toks = torch.randint(0, cfg.vocab, (1, S), device="cuda",
                             generator=gen, dtype=torch.int32)
        ops.reset_kernel_counters()
        got = g.run(toks.cpu(), slot, off).clone()
        replayed = ops.counter_snapshot()
        ops.reset_kernel_counters()
        want, _ = prefill_into_slot(params, cfg, toks, ref, slot,
                                    write_offset=off)
        counts = ops.counter_snapshot()
        assert torch.equal(got, want), turn
        for k in ("k", "v"):
            assert torch.equal(cache[k], ref[k]), (turn, k)
        assert replayed == counts, turn
        if fmt != "dense":
            kernel = "nmg_gemv" if S <= 16 else "nmg_spmm"
            assert counts["launches"][kernel] > 0, counts
    assert g.info["captured"] and g.info["replays"] == 2
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs


@pytest.mark.parametrize("where", ["prefill", "decode_chunk"])
def test_capture_raises_on_a_host_sync(monkeypatch, where):
    """A GEMV wrapper whose launch syncs the card cannot be captured.
    ``prefill``: the engine's first admission (a 5-token prompt, through
    the GEMV) raises and no graph is kept.  ``decode_chunk``: the 5-token
    admission program is built before the patch, so the admission replays
    and the first decode chunk's capture raises.  Either way no request
    finishes, no decode step is counted, and nothing runs the eager program
    in its place."""
    _require_cuda()
    import numpy as np

    from repro_torch.serve import Request, ServeEngine

    cfg, params = _served("bert-base-sten")
    prompt = np.arange(1, 6, dtype=np.int32)
    original = nmg_gemv.gemv_launch

    def syncing(*args, **kwargs):
        torch.cuda.synchronize()
        return original(*args, **kwargs)

    eng = ServeEngine(params, cfg, max_slots=2, max_seq_len=32,
                      decode_chunk=4)
    if where == "decode_chunk":
        eng.kv.write_prefill(params, prompt[None], 1)
        assert eng.kv.prefill_graphs[5].graph is not None
    monkeypatch.setattr(nmg_gemv, "gemv_launch", syncing)
    with pytest.raises(RuntimeError):
        eng.run([Request(uid=0, prompt=prompt, max_new_tokens=8)])
    assert eng._outputs == []
    if where == "prefill":
        assert eng.kv.prefill_graphs[5].graph is None
    else:
        assert eng.kv.prefill_graphs[5].info["replays"] == 1
    assert eng._decode_chunk.graph is None
    assert eng.stats["decode_steps"] == 0
    monkeypatch.undo()
    torch.cuda.synchronize()              # the card is usable afterwards
    out = ServeEngine(params, cfg, max_slots=2, max_seq_len=32,
                      decode_chunk=4).run([Request(
                          uid=0, prompt=prompt, max_new_tokens=8)])
    assert len(out[0].tokens) == 8


# ---------------------------------------------------------------------------
# the training step replayed as a CUDA graph (launch/graphs.py)
# ---------------------------------------------------------------------------


def _trained(how):
    """The SMOKE config of bert-base-sten (bf16) with seeded weights on
    the card: magnitude-pruned FixedMask leaves, or NMSparsifier(2, 4)
    leaves on ``mlp.wo`` / ``attn.wo`` with the inline threshold 0.5 on
    ``mlp.wi`` (``matmul_threshold`` inside the captured step, ``nm_mask``
    at the recomputes between replays)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.core.builder import SparsityBuilder
    from repro_torch.core.layouts import FixedMaskTensor
    from repro_torch.core.sparsifiers import NMSparsifier
    from repro_torch.launch.train import build_sparse_params
    from repro_torch.models import init_lm

    cfg = get_smoke("bert-base-sten")
    if how == "nm_inline":
        cfg = dataclasses.replace(cfg, mlp_inline_threshold=0.5)
    params = init_lm(cfg, seed=0, device="cuda")
    if how == "scalar_fraction":
        return cfg, build_sparse_params(params, 0.3)
    sb = SparsityBuilder()
    for pat in ("*mlp.wo*", "*attn.wo*"):
        sb.set_weight(pat, NMSparsifier(2, 4), FixedMaskTensor)
    return cfg, sb.sparsify_params(params)


def _train_state(params, opt_state):
    from repro_torch.launch.graphs import state_tensors

    return state_tensors(params, opt_state)


@pytest.mark.parametrize("how", ["scalar_fraction", "nm_inline"])
def test_train_graph_replay_bitwise_eager(how):
    """Seven steps in chunks of 3 through the graph trainer (step 0 eager
    and captured, steps 1..6 replayed, pattern recomputes before steps 2,
    4 and 6, between replays) against the host loop from a clone of the
    same state: losses, gradient norms, params, masks, moments and step
    counter bit for bit, and equal launch counts."""
    _require_cuda()
    from repro_torch.core.layouts import FixedMaskTensor
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import AdamWConfig, GMPSchedule, adamw_init
    from repro_torch.optim.optimizers import tree_map

    cfg, params = _trained(how)
    start = tree_map(lambda p: FixedMaskTensor(p.val.clone(), p.mask.clone(),
                                               p.origin)
                     if isinstance(p, FixedMaskTensor) else p.clone(),
                     params)
    gmp = GMPSchedule(mode="iterative", target_sparsity=0.6, begin_step=0,
                      end_step=7, recompute_every=2, num_layers=cfg.n_layers)
    data = SyntheticLMPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                          global_batch=2, seed=3))
    ops.reset_kernel_counters()
    multi = ttrain.make_multi_step(cfg, AdamWConfig(), gmp, 3)
    state, losses, gnorms = adamw_init(params), [], []
    for lo in (0, 3, 6):
        hi = min(7, lo + 3)
        params, state, m = multi(params, state,
                                 ttrain.stack_batches(data, lo, hi), lo, 7)
        losses += m["loss"].tolist()
        gnorms += m["gnorm"].tolist()
    replayed = ops.counter_snapshot()
    assert multi.graph.info["captured"] and multi.graph.info["replays"] == 6
    ops.reset_kernel_counters()
    host = ttrain.train_loop(start, adamw_init(start),
                             ttrain.make_train_step(cfg, AdamWConfig()),
                             data, start=0, stop=7, device="cuda", gmp=gmp)
    assert host["recomputes"] == [0, 2, 4, 6]
    assert losses == host["losses"] and gnorms == host["gnorms"]
    for a, b in zip(_train_state(params, state),
                    _train_state(host["params"], host["opt_state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert replayed == ops.counter_snapshot()
    if how == "nm_inline":
        assert replayed["launches"]["matmul_threshold"] == 7 * cfg.n_layers
        assert replayed["launches"]["nm_mask"] == 2 * 4


def test_train_capture_raises_and_leaves_no_graph():
    """A step that syncs with the host cannot be captured: the first run
    (eager, then the capture) raises, leaves no graph, and the card is
    usable afterwards; nothing runs the eager step in its place."""
    _require_cuda()
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.graphs import TrainGraph
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg, params = _trained("scalar_fraction")
    step = ttrain.make_train_step(cfg, AdamWConfig())

    def syncing(p, s, b):
        out = step(p, s, b)
        float(out[2]["loss"])
        return out

    state = adamw_init(params)
    batch = {k: torch.ones((2, 16), dtype=torch.int32, device="cuda")
             for k in ("tokens", "labels")}
    graph = TrainGraph(syncing, params, state, batch)
    with pytest.raises(RuntimeError):
        graph.run(batch)
    assert graph.graph is None and not graph.info["captured"]
    torch.cuda.synchronize()
    assert int(state["step"]) == 1         # the eager run, nothing more
    eager = TrainGraph(step, params, state, batch, capture=False)
    assert torch.isfinite(eager.run(batch)).all()
    assert int(state["step"]) == 2


# ---------------------------------------------------------------------------
# the programming model on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m", [(2, 4), (16, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_tensor_from_dense_through_the_kernel(dtype, n, m, monkeypatch):
    """``NMTensor.from_dense`` of bert-base-sten's ``mlp.wo`` [3072, 768]
    launches the ``nm_mask`` kernel once, and its offsets and values equal
    the build through the plain version bitwise."""
    _require_cuda()
    from repro_torch.core.layouts import NMTensor

    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(3072, 768, generator=g, device="cuda").to(dtype)
    before = nm_mask.nm_mask.launches
    got = NMTensor.from_dense(x, n, m)
    assert nm_mask.nm_mask.launches == before + 1
    monkeypatch.setattr(nm_mask, "nm_mask", nm_mask.nm_mask_plain)
    want = NMTensor.from_dense(x, n, m)
    assert torch.equal(got.idx, want.idx) and torch.equal(got.val, want.val)
    assert got.val.shape == (3072, 768 // m, n)
    d = got.to_dense()
    kept = d != 0
    assert torch.equal(d[kept], x[kept])
    assert int(kept.sum()) == x.numel() * n // m


def test_fused_sparsified_op_launches_matmul_threshold_once():
    """``sparsified_op(matmul, (ScalarThreshold(0.5), FixedMask, KeepAll,
    FixedMask))`` on ``DenseTensor`` operands at the training path's
    shape ([1024, 768] x [768, 3072], bf16): one ``matmul_threshold``
    launch, no dense fallback, equal to the plain version under the
    kernel's rule (values within 1e-5, the mask off the threshold)."""
    _require_cuda()
    import warnings

    from repro_torch import sten
    from repro_torch.core.layouts import DenseTensor, FixedMaskTensor
    from repro_torch.core.sparsifiers import KeepAll, \
        ScalarThresholdSparsifier

    a, b = _mt_operands(1024, 768, 3072, torch.bfloat16)
    op = sten.sparsified_op(torch.matmul, sten.OutFormat(
        ScalarThresholdSparsifier(0.5), FixedMaskTensor, KeepAll(),
        FixedMaskTensor))
    before = fused_sparse_matmul.matmul_threshold.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error", sten.SparseFallbackWarning)
        out = op(DenseTensor(a), DenseTensor(b))
    assert fused_sparse_matmul.matmul_threshold.launches == before + 1
    assert isinstance(out, FixedMaskTensor)
    pv, pm = fused_sparse_matmul.matmul_threshold_plain(a, b, 0.5)
    diff = _check_mask(out.mask, pm, a, b, 0.5)
    torch.testing.assert_close(out.val[~diff], pv[~diff], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["csr_dense", "dense_csr", "coo_add"])
def test_unstructured_products_on_the_card(case):
    """CSR @ dense, dense @ CSR and COO + COO at [3072, 768], 70% sparse,
    on CUDA tensors: allclose to the dense result (``index_add`` adds in
    no fixed order there)."""
    _require_cuda()
    from repro_torch import sten
    from repro_torch.core.layouts import CooTensor, CsrTensor

    g = torch.Generator(device="cuda").manual_seed(3)
    sp = sten.ScalarFractionSparsifier(0.7)
    w = torch.randn(3072, 768, generator=g, device="cuda")
    if case == "coo_add":
        v = torch.randn(3072, 768, generator=g, device="cuda")
        a = sten.apply_sparsifier(sp, w, CooTensor)
        c = sten.apply_sparsifier(sp, v, CooTensor)
        out = sten.add(a, c)
        assert isinstance(out, CooTensor)
        torch.testing.assert_close(out.to_dense(), a.to_dense()
                                   + c.to_dense(), rtol=0, atol=0)
        return
    csr = sten.apply_sparsifier(sp, w, CsrTensor)
    assert abs(csr.density() - 0.3) < 1e-3
    if case == "csr_dense":
        b = torch.randn(768, 256, generator=g, device="cuda")
        got, want = sten.matmul(csr, b), csr.to_dense() @ b
    else:
        b = torch.randn(256, 3072, generator=g, device="cuda")
        got, want = sten.matmul(b, csr), b @ csr.to_dense()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# tuned kernel configs (repro_torch.tune)
# ---------------------------------------------------------------------------


def _ints(shape, gen):
    """Small integers: every product and partial sum exact in f32, so any
    summation order gives the same bits."""
    return torch.randint(-4, 5, shape, generator=gen, device="cuda").float()


@pytest.mark.parametrize("K,R", [(768, 3072), (2560, 2560)])
def test_every_tuned_config_matches_plain(K, R):
    """Every ``gemv_cuda`` config the tuner can pick at bert and qwen
    widths (tile rows 16/32/64, every K part count the body takes), at M =
    4 and 16, and every SpMM split it can pick (up to 8) at N = 24 and 64,
    against the plain version at the tolerance above.  ``rows`` moves no
    summation (bitwise on small integers against the body's own plan);
    ``parts`` and ``splits`` reassociate the f32 sum (small integers:
    bitwise too, being exact)."""
    _require_cuda()
    from repro_torch.kernels.nmg_gemv import tc_parts_choices
    from repro_torch.kernels.nmg_spmm import spmm_split_choices

    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(K)
    w = dense_to_grouped_nm(torch.randn(K, R, generator=g, device="cuda"),
                            1, 4, 8, gr=64, sparse_dim=0).to(dtype=bf16)
    wi = dense_to_grouped_nm(_ints((K, R), g), 1, 4, 8, gr=64,
                             sparse_dim=0).to(dtype=bf16)
    KN = w.val.shape[1] * w.val.shape[2]
    for M in (4, 16):
        x = torch.randn(M, K, generator=g, device="cuda").to(bf16)
        xi = _ints((M, K), g).to(bf16)
        want = nmg_gemv.nmg_gemv_plain(w, x.T, transpose_out=True)
        own = nmg_gemv.nmg_gemv(wi, xi.T, transpose_out=True)
        for rows in (16, 32, 64):
            for parts in tc_parts_choices(KN):
                cfg = {"rows": rows, "parts": parts}
                got = nmg_gemv.nmg_gemv(w, x.T, transpose_out=True,
                                        config=cfg)
                torch.testing.assert_close(got, want, **TOL)
                assert torch.equal(nmg_gemv.nmg_gemv(
                    wi, xi.T, transpose_out=True, config=cfg), own), cfg
    for N in (24, 64):
        x = torch.randn(N, K, generator=g, device="cuda").to(bf16)
        want = nmg_spmm.nmg_spmm_plain(w, x.T)
        for z in spmm_split_choices(KN, bf16, most=8):
            torch.testing.assert_close(nmg_spmm.nmg_spmm(w, x.T, splits=z),
                                       want, **TOL)
    with pytest.raises(ValueError):
        nmg_gemv.nmg_gemv(w, x[:4].T, config={"rows": 64, "parts": 99})
    with pytest.raises(ValueError):
        nmg_spmm.nmg_spmm(w, x.T, splits=10 ** 6)


def test_fused_qkv_and_ffn_bitwise_sequential_under_a_table():
    """With a ``gemv_cuda`` entry that is not the body's own plan, the
    fused QKV launch equals the per-projection GEMVs bit for bit, and the
    fused FFN equals the GEMV followed by silu and multiply: the entry's
    key has no R, so all of them run the same body."""
    _require_cuda()
    from repro_torch.kernels import ops
    from repro_torch.tune import TuningTable, routing

    bf16 = torch.bfloat16
    ws = _weights(768, 768, bf16, count=3)
    (wi,) = _weights(768, 2 * 1536, bf16, seed=5)
    tab = TuningTable.for_device()
    cfg = {"rows": 32, "parts": 3}
    tab.put(routing.gemv_cuda_key(K=768, fmt=(1, 4, 8), gr=64, dtype=bf16),
            cfg)
    routing.set_active_table(tab)
    try:
        # a generator of its own: the default one may be left in a
        # capture state by the capture-error tests above
        g = torch.Generator(device="cuda").manual_seed(4)
        x = torch.randn(4, 768, generator=g, device="cuda").to(bf16)
        fused = ops.maybe_fused_qkv(x, ws)
        for f, w in zip(fused, ws):
            assert torch.equal(f, ops.nmg_linear(x, w))
            assert torch.equal(f, nmg_gemv.nmg_gemv(
                w, x.T, out_dtype=bf16, transpose_out=True, config=cfg))
        u, v = ops.nmg_linear(x, wi).chunk(2, dim=-1)
        assert torch.equal(ops.maybe_fused_ffn(x, wi),
                           torch.nn.functional.silu(u) * v)
        tab.put(routing.gemv_cuda_key(K=768, fmt=(1, 4, 8), gr=64,
                                      dtype=bf16), {"rows": 64, "parts": 7})
        with pytest.raises(ValueError):        # 3 slabs: no 7 parts
            ops.maybe_fused_qkv(x, ws)
    finally:
        routing.clear_active_table()


@pytest.mark.parametrize("M", [24, 64])
def test_gemv_routed_past_16_columns(M):
    """A table that moves the crossover past 16 routes M = 24 and 64
    through the GEMV kernel (16 columns at a time), against the plain
    version; the fused QKV declines past the kernels' 16-column tile and
    the projections run per projection through the same GEMV."""
    _require_cuda()
    from repro_torch.kernels import ops
    from repro_torch.tune import TuningTable, routing

    bf16 = torch.bfloat16
    ws = _weights(768, 768, bf16, count=3)
    tab = TuningTable.for_device()
    tab.put("decode_m_max", 4096)
    routing.set_active_table(tab)
    try:
        g = torch.Generator(device="cuda").manual_seed(M)
        x = torch.randn(M, 768, generator=g, device="cuda").to(bf16)
        ops.reset_kernel_counters()
        y = ops.nmg_linear(x, ws[0])
        assert ops.kernel_counters() == {("nmg_linear", "gemv[table]"): 1,
                                         ("nmg_gemv", "cuda"): 1}
        torch.testing.assert_close(y.float(), nmg_gemv.nmg_gemv_plain(
            ws[0], x.T, out_dtype=bf16, transpose_out=True).float(),
            rtol=2 ** -7, atol=1e-3)
        torch.testing.assert_close(
            ops.nmg_matmul(ws[0], x.T),
            nmg_gemv.nmg_gemv_plain(ws[0], x.T), **TOL)
        assert ops.maybe_fused_qkv(x, ws) is None
    finally:
        routing.clear_active_table()
