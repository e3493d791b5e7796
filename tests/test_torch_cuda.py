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


def _card_weight(K, R, dtype, seed=0, gr=64):
    """An n:m:g 1:4:8 weight [K, R] converted on the card, values scaled
    by 1/sqrt(K) so products stay O(1) at any K."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dense = torch.randn(K, R, generator=g, device="cuda") / K ** 0.5
    return dense_to_grouped_nm(dense.to(dtype), 1, 4, 8, gr=gr,
                               sparse_dim=0)


@pytest.mark.parametrize("M", [1, 4, 16])
def test_ffn_gelu_at_gemma2_width(M):
    """The fused FFN with gelu at gemma2-9b's packed [3584, 28672] wi
    (bf16, gr64): the f32 output against the plain version, the bf16
    output against the GEMV followed by gelu-tanh · v (the bound of
    ``test_ffn_matches_plain_and_sequential``) and bitwise against a
    second launch."""
    _require_cuda()
    bf16 = torch.bfloat16
    w = _card_weight(3584, 2 * 14336, bf16)
    g = torch.Generator(device="cuda").manual_seed(M)
    x = torch.randn(M, 3584, generator=g, device="cuda").to(bf16)
    torch.testing.assert_close(
        nmg_fused.nmg_ffn(w, x.T, act="gelu", transpose_out=True),
        nmg_fused.nmg_ffn_plain(w, x.T, act="gelu", transpose_out=True),
        **TOL)
    fused = nmg_fused.nmg_ffn(w, x.T, act="gelu", out_dtype=bf16,
                              transpose_out=True)
    assert fused.shape == (M, 14336)
    u, v = nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16,
                             transpose_out=True).chunk(2, dim=-1)
    torch.testing.assert_close(
        fused.float(), (nmg_fused.act_fn("gelu")(u) * v).float(),
        atol=1e-6, rtol=2 ** -7)
    assert torch.equal(fused, nmg_fused.nmg_ffn(
        w, x.T, act="gelu", out_dtype=bf16, transpose_out=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemv_and_spmm_at_k_24576(dtype):
    """starcoder2-15b's mlp.wo [24576, 6144] (the widest contraction the
    port serves): the GEMV at M = 4 and 16 and the SpMM at N = 32 and 64
    against their plain versions, each bitwise against a second launch."""
    _require_cuda()
    w = _card_weight(24576, 6144, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    for M in (4, 16):
        x = torch.randn(24576, M, generator=g, device="cuda").to(dtype)
        got = nmg_gemv.nmg_gemv(w, x)
        torch.testing.assert_close(got, nmg_gemv.nmg_gemv_plain(w, x),
                                   **TOL)
        assert torch.equal(got, nmg_gemv.nmg_gemv(w, x)), M
    for N in (32, 64):
        x = torch.randn(24576, N, generator=g, device="cuda").to(dtype)
        got = nmg_spmm.nmg_spmm(w, x)
        torch.testing.assert_close(got, nmg_spmm.nmg_spmm_plain(w, x),
                                   **TOL)
        assert torch.equal(got, nmg_spmm.nmg_spmm(w, x)), N


@pytest.mark.parametrize("fmt", ["dense", "nmg"])
def test_ring_cache_engine_replay_bitwise_eager(fmt):
    """gemma2-9b SMOKE (bf16, window 16; n:m:g 1:4:8 gr16 ``attn=True``
    or dense) served by an engine of 2 slots x 40 rows, local rings of 16
    rows: prompts 20, 6, 20, 6 with 12 new tokens each, chunk 4 (a
    20-token admission wraps the ring, and every request wraps it while
    its chunks replay).  With graphs and with ``graphs=False``: token
    streams and launch counts equal.  Then an admission replayed into
    slot 1 against eager ``prefill_into_slot`` on a clone of the cache:
    logits and every leaf bitwise."""
    _require_cuda()
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.models import init_lm, prefill_into_slot
    from repro_torch.models.transformer import cache_leaves, map_cache
    from repro_torch.serve import Request, ServeEngine, \
        sparsify_for_serving, warmup_engine

    cfg = get_smoke("gemma2-9b")
    params = init_lm(cfg, seed=0, device="cuda")
    if fmt == "nmg":
        params = sparsify_for_serving(params, 1, 4, 8, gr=16, attn=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (20, 6, 20, 6)]

    def trace():
        return [Request(uid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]

    runs = {}
    for graphs in (True, False):
        eng = ServeEngine(params, cfg, max_slots=2, max_seq_len=40,
                          decode_chunk=4, graphs=graphs)
        assert eng.kv.data["local"]["k"].shape[2] == cfg.local_window
        warmup_engine(eng, trace())
        ops.reset_kernel_counters()
        outs = eng.run(trace())
        runs[graphs] = ([o.tokens for o in outs], ops.counter_snapshot())
        if not graphs:
            continue
        assert eng._decode_chunk.info["captured"]
        assert all(g.info["captured"] and g.info["replays"] == 2
                   for g in eng.kv.prefill_graphs.values())
        prompt = rng.integers(0, cfg.vocab, (1, 20), dtype=np.int32)
        ref = map_cache(torch.clone, eng.kv.data)
        got = eng.kv.write_prefill(params, prompt, 1).clone()
        want, _ = prefill_into_slot(
            params, cfg, torch.as_tensor(prompt, device="cuda"), ref, 1)
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in
                   zip(cache_leaves(eng.kv.data), cache_leaves(ref)))
    assert runs[True] == runs[False]
    assert all(len(t) == 12 for t in runs[True][0])
    launches = runs[True][1]["launches"]
    if fmt == "nmg":
        for k in ("nmg_gemv", "nmg_qkv", "nmg_ffn"):
            assert launches[k] > 0, (k, launches)
    else:
        assert not any(launches.values()), launches


def _new_family(arch, fmt, dtype=None):
    """The SMOKE config of ``arch`` (``dtype`` if given, else its bf16)
    with seeded weights on the card: dense, or n:m:g 1:4:8 gr16 with
    ``attn=True`` (paligemma's MQA q/k/v through the fused launch; of an
    MLA layer only ``attn.wo``)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import init_lm
    from repro_torch.serve import sparsify_for_serving

    cfg = get_smoke(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    params = init_lm(cfg, seed=0, device="cuda")
    if fmt == "nmg":
        params = sparsify_for_serving(params, 1, 4, 8, gr=16, attn=True)
    return cfg, params


def _prefix_on_card(cfg, seed=0):
    if not cfg.vision_prefix:
        return None
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(1, cfg.vision_prefix, cfg.d_model, generator=g,
                       device="cuda").to(cfg.tdtype)


@pytest.mark.parametrize("arch", ["paligemma-3b", "minicpm3-4b"])
def test_new_family_decode_kernels_match_plain(arch, monkeypatch):
    """f32 SMOKE, n:m:g 1:4:8 gr16 ``attn=True``: an admission into slot 1
    (paligemma behind its prefix, minicpm3 into the compressed
    ``{"ckv", "kr"}`` cache) and 6 decode steps of both slots through the
    kernels, against the same steps fed the same tokens with every
    wrapper swapped for its plain version: logits and every cache leaf
    within rtol 1e-4, atol 1e-3 (f32 sums in another order, through two
    layers and the head), and the kernels of the path launched (no fused
    QKV at MLA, whose q/k/v-like projections stay dense)."""
    _require_cuda()
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_cache, \
        prefill_into_slot
    from repro_torch.models.transformer import cache_leaves

    cfg, params = _new_family(arch, "nmg", dtype="float32")
    pe = _prefix_on_card(cfg)
    P = cfg.vision_prefix
    g = torch.Generator(device="cuda").manual_seed(2)
    # 20 prompt rows (past 16: the SpMM) after any prefix
    toks = torch.randint(0, cfg.vocab, (1, 20), generator=g, device="cuda",
                         dtype=torch.int32)

    def run(feed=None):
        cache = init_cache(cfg, 2, 40, device="cuda")
        logits, _ = prefill_into_slot(params, cfg, toks, cache, 1,
                                      prefix_embeds=pe)
        outs, fed = [logits], []
        tok = torch.stack([torch.zeros_like(logits[0, 0]).int(),
                           logits[0].argmax().int()])[:, None]
        for i in range(6):
            if feed is not None:
                tok = feed[i]
            fed.append(tok)
            logits, _ = decode_step(params, cfg, tok, cache, torch.tensor(
                [i, P + 20 + i], device="cuda"))
            outs.append(logits)
            tok = logits.argmax(-1).int()[:, None]
        return outs, fed, cache

    ops.reset_kernel_counters()
    got, fed, cache = run()
    launches = ops.counter_snapshot()["launches"]
    for k in ("nmg_gemv", "nmg_spmm", "nmg_ffn"):
        assert launches[k] > 0, (k, launches)
    assert (launches["nmg_qkv"] > 0) == (cfg.attn_type == "gqa"), launches
    for mod, attr, plain in ops.KERNEL_WRAPPERS.values():
        monkeypatch.setattr(mod, attr, getattr(mod, plain))
    want, _, ref = run(fed)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
    for a, b in zip(cache_leaves(cache), cache_leaves(ref)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("fmt", ["dense", "nmg"])
@pytest.mark.parametrize("arch", ["paligemma-3b", "minicpm3-4b"])
def test_new_family_engine_replay_bitwise_eager(arch, fmt):
    """bf16 SMOKE served by an engine of 2 slots x 48 rows (prompts 20,
    6, 20, 6, 8 new tokens each, chunk 4), with graphs and with
    ``graphs=False``: token streams and launch counts equal, and an
    admission replayed into slot 1 bitwise eager ``prefill_into_slot``
    (logits and every leaf; minicpm3's ``{"ckv", "kr"}``).  Then a
    prefix admission at paligemma (``prefill_into_slot(prefix_embeds=)``
    into slot 0 of the engine's cache) decoded by the engine's chunk
    program, its replay bitwise the eager program on a clone of the
    cache."""
    _require_cuda()
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import prefill_into_slot
    from repro_torch.models.transformer import cache_leaves, map_cache
    from repro_torch.serve import Request, ServeEngine, warmup_engine
    from repro_torch.serve.engine import _decode_chunk_fn

    cfg, params = _new_family(arch, fmt)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (20, 6, 20, 6)]

    def trace():
        return [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in
                   zip(cache_leaves(a), cache_leaves(b)))

    runs = {}
    for graphs in (True, False):
        eng = ServeEngine(params, cfg, max_slots=2, max_seq_len=48,
                          decode_chunk=4, graphs=graphs)
        warmup_engine(eng, trace())
        ops.reset_kernel_counters()
        outs = eng.run(trace())
        runs[graphs] = ([o.tokens for o in outs], ops.counter_snapshot())
        if not graphs:
            continue
        assert eng._decode_chunk.info["captured"]
        assert all(g.info["captured"] and g.info["replays"] == 2
                   for g in eng.kv.prefill_graphs.values())
        prompt = rng.integers(0, cfg.vocab, (1, 20), dtype=np.int32)
        ref = map_cache(torch.clone, eng.kv.data)
        got = eng.kv.write_prefill(params, prompt, 1).clone()
        want, _ = prefill_into_slot(
            params, cfg, torch.as_tensor(prompt, device="cuda"), ref, 1)
        assert torch.equal(got, want) and same(eng.kv.data, ref)
        pe = _prefix_on_card(cfg, 3)
        if pe is None:
            continue
        toks = torch.as_tensor(prompt[:, :12], device="cuda")
        logits, _ = prefill_into_slot(params, cfg, toks, eng.kv.data, 0,
                                      prefix_embeds=pe)
        tok = np.array([int(logits[0].argmax()), 0], np.int32)
        pos = np.array([cfg.vision_prefix + 12, 20], np.int32)
        for _ in range(2):
            ref = map_cache(torch.clone, eng.kv.data)
            got = eng._decode_chunk.run(tok, pos).clone()
            want = _decode_chunk_fn(cfg, 4)(
                params, torch.as_tensor(tok[:, None], device="cuda"), ref,
                torch.as_tensor(pos, device="cuda"))
            assert torch.equal(got, want) and same(eng.kv.data, ref)
            tok, pos = got[-1].cpu().numpy().astype(np.int32), pos + 4
    assert runs[True] == runs[False]
    assert all(len(t) == 8 for t in runs[True][0])
    launches = runs[True][1]["launches"]
    if fmt == "nmg":
        for k in ("nmg_gemv", "nmg_ffn"):
            assert launches[k] > 0, (k, launches)
        assert (launches["nmg_qkv"] > 0) == (cfg.attn_type == "gqa")
    else:
        assert not any(launches.values()), launches


# ---------------------------------------------------------------------------
# MoE (moonshot-v1-16b-a3b, arctic-480b) at SMOKE: the capacity dispatch
# inside the decode and admission graphs, the router's f32, pinned routes
# ---------------------------------------------------------------------------

MOE_ARCHES = ["moonshot-v1-16b-a3b", "arctic-480b"]


@pytest.mark.parametrize("fmt", ["dense", "nmg"])
@pytest.mark.parametrize("arch", MOE_ARCHES)
def test_moe_engine_replay_bitwise_eager(arch, fmt):
    """bf16 SMOKE (4 experts top-2; arctic with its dense residual)
    served by an engine of 4 slots x 48 rows (prompts 20, 6, 20, 6, 9; 8
    new tokens each, chunk 4), with graphs and with ``graphs=False``:
    token streams and launch counts equal.  Then each admission length,
    replayed into slot 1, bitwise eager ``prefill_into_slot`` (logits and
    every leaf), and the decode chunk's replay bitwise the eager program
    on a clone of the cache.  The capacity comes from the static token
    count (4 slots at decode, the prompt length at admission), so nothing
    in a step reads the device from the host."""
    _require_cuda()
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import prefill_into_slot
    from repro_torch.models.transformer import cache_leaves, map_cache
    from repro_torch.serve import Request, ServeEngine, warmup_engine
    from repro_torch.serve.engine import _decode_chunk_fn

    cfg, params = _new_family(arch, fmt)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (20, 6, 20, 6, 9)]

    def trace():
        return [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in
                   zip(cache_leaves(a), cache_leaves(b)))

    runs = {}
    for graphs in (True, False):
        eng = ServeEngine(params, cfg, max_slots=4, max_seq_len=48,
                          decode_chunk=4, graphs=graphs)
        warmup_engine(eng, trace())
        ops.reset_kernel_counters()
        outs = eng.run(trace())
        runs[graphs] = ([o.tokens for o in outs], ops.counter_snapshot())
        if not graphs:
            continue
        assert eng._decode_chunk.info["captured"]
        assert sorted(eng.kv.prefill_graphs) == [6, 9, 20]
        for S, g in eng.kv.prefill_graphs.items():
            assert g.info["captured"], S
            prompt = rng.integers(0, cfg.vocab, (1, S), dtype=np.int32)
            ref = map_cache(torch.clone, eng.kv.data)
            got = eng.kv.write_prefill(params, prompt, 1).clone()
            want, _ = prefill_into_slot(
                params, cfg, torch.as_tensor(prompt, device="cuda"), ref, 1)
            assert torch.equal(got, want) and same(eng.kv.data, ref), S
        tok = rng.integers(0, cfg.vocab, 4).astype(np.int32)
        pos = np.array([20, 3, 9, 30], np.int32)
        for _ in range(2):
            ref = map_cache(torch.clone, eng.kv.data)
            got = eng._decode_chunk.run(tok, pos).clone()
            want = _decode_chunk_fn(cfg, 4)(
                params, torch.as_tensor(tok[:, None], device="cuda"), ref,
                torch.as_tensor(pos, device="cuda"))
            assert torch.equal(got, want) and same(eng.kv.data, ref)
            tok, pos = got[-1].cpu().numpy().astype(np.int32), pos + 4
    assert runs[True] == runs[False]
    assert all(len(t) == 8 for t in runs[True][0])
    launches = runs[True][1]["launches"]
    if fmt == "nmg":
        for k in ("nmg_gemv", "nmg_qkv", "nmg_spmm"):
            assert launches[k] > 0, (k, launches)
        assert launches["nmg_ffn"] == 0, launches    # no mlp.wi
    else:
        assert not any(launches.values()), launches


@pytest.mark.parametrize("arch", MOE_ARCHES)
def test_moe_router_is_full_f32_under_tf32(arch):
    """With TF32 allowed for the whole process, the router's probabilities
    (``route_log``) equal those with it off bit for bit and lie within
    f32 rounding of a float64 product; the experts taken and the slots
    kept are the same.  (The expert products follow the process's
    setting, as the reference's einsums follow its default precision.)"""
    _require_cuda()
    from repro_torch.models import moe

    cfg, params = _new_family(arch, "dense", dtype="float32")
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2, 40, cfg.d_model, generator=g, device="cuda")
    runs = []
    for tf32 in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with moe.route_log() as log:
                moe.apply_moe(p, x, cfg)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        runs.append(log.calls[0])
    c1, c2 = runs
    for key in ("probs", "eidx", "keep"):
        assert torch.equal(c1[key], c2[key]), key
    want = torch.softmax(x.reshape(-1, cfg.d_model).double()
                         @ p["router"].double(), -1)
    torch.testing.assert_close(c1["probs"].double(), want, rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("arch", MOE_ARCHES)
def test_moe_kernels_match_plain_with_routes_pinned(arch, monkeypatch):
    """f32 SMOKE, n:m:g 1:4:8 gr16 ``attn=True``: an admission of 20
    tokens into slot 1 and 6 decode steps of both slots through the
    plain versions with every MoE layer's experts recorded, then through
    the kernels fed the same tokens with those experts pinned: logits
    within rtol 1e-4, atol 1e-3 (f32 sums in another order), and every
    pinned choice the kernels' own top-k but for near-ties (within 1e-5
    in probability)."""
    _require_cuda()
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_cache, moe, \
        prefill_into_slot

    cfg, params = _new_family(arch, "nmg", dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (1, 20), generator=g, device="cuda",
                         dtype=torch.int32)

    def run(feed=None):
        cache = init_cache(cfg, 2, 40, device="cuda")
        logits, _ = prefill_into_slot(params, cfg, toks, cache, 1)
        outs, fed = [logits], []
        tok = torch.stack([torch.zeros_like(logits[0, 0]).int(),
                           logits[0].argmax().int()])[:, None]
        for i in range(6):
            if feed is not None:
                tok = feed[i]
            fed.append(tok)
            logits, _ = decode_step(params, cfg, tok, cache, torch.tensor(
                [i, 20 + i], device="cuda"))
            outs.append(logits)
            tok = logits.argmax(-1).int()[:, None]
        return outs, fed

    with monkeypatch.context() as m:
        for mod, attr, plain in ops.KERNEL_WRAPPERS.values():
            m.setattr(mod, attr, getattr(mod, plain))
        with moe.route_log() as rec:
            want, fed = run()
    ops.reset_kernel_counters()
    with moe.route_log(pin=rec.routes) as pin:
        got, _ = run(fed)
    launches = ops.counter_snapshot()["launches"]
    for k in ("nmg_gemv", "nmg_qkv", "nmg_spmm"):
        assert launches[k] > 0, (k, launches)
    assert len(pin.calls) == len(rec.calls) == 7 * cfg.n_layers
    for c in pin.calls:
        taken = c["probs"].gather(1, c["eidx"]).min(1).values
        others = c["probs"].scatter(1, c["eidx"], float("-inf")).max(1).values
        assert bool((taken >= others - 1e-5).all())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)


SSM_ARCHES = ["mamba2-370m", "hymba-1.5b"]


def _ssm_family(arch, fmt, dtype=None):
    """The SMOKE config of ``arch`` (``dtype`` if given, else its bf16)
    with seeded weights on the card: dense, or n:m:g 1:4:8 gr16 (mamba2:
    ``*ssm.in_proj`` / ``*ssm.out_proj`` through a ``SparsityBuilder``
    plan; hymba: ``sparsify_for_serving(attn=True)``)."""
    if arch != "mamba2-370m" or fmt == "dense":
        return _new_family(arch, fmt, dtype)
    from repro_torch.core.builder import SparsityBuilder
    from repro_torch.core.layouts import GroupedNMTensor
    from repro_torch.core.sparsifiers import GroupedNMSparsifier

    cfg, params = _new_family(arch, "dense", dtype)
    sb = SparsityBuilder()
    sp = GroupedNMSparsifier(1, 4, 8, 16, sparse_dim=0)
    sb.set_weight("*ssm.in_proj", sp, GroupedNMTensor)
    sb.set_weight("*ssm.out_proj", sp, GroupedNMTensor)
    return cfg, sb.sparsify_params(params)


@pytest.mark.parametrize("fmt", ["dense", "nmg"])
@pytest.mark.parametrize("arch", SSM_ARCHES)
def test_ssm_engine_replay_bitwise_eager(arch, fmt):
    """bf16 SMOKE served by an engine of 4 slots x 40 rows (hymba: longer
    than its window of 16, so local layers attend over the window of a
    full-length cache; prompts 20, 6, 20, 6, 9; 8 new tokens each, chunk
    4), with graphs and with ``graphs=False``: token streams and launch
    counts equal.  Then each admission length, replayed into slot 1,
    bitwise eager ``prefill_into_slot`` (logits and every leaf, the
    ``ssm_state`` leaves among them), and the decode chunk's replay
    bitwise the eager program on a clone of the cache.  Every leaf keeps
    its storage (``data_ptr``) from the engine's start: the state is
    written in place by every replay, and the replays do move it."""
    _require_cuda()
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import prefill_into_slot
    from repro_torch.models.transformer import cache_leaves, map_cache
    from repro_torch.serve import Request, ServeEngine, warmup_engine
    from repro_torch.serve.engine import _decode_chunk_fn

    cfg, params = _ssm_family(arch, fmt)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (20, 6, 20, 6, 9)]

    def trace():
        return [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in
                   zip(cache_leaves(a), cache_leaves(b)))

    runs = {}
    for graphs in (True, False):
        eng = ServeEngine(params, cfg, max_slots=4, max_seq_len=40,
                          decode_chunk=4, graphs=graphs)
        ptrs = [t.data_ptr() for t in cache_leaves(eng.kv.data)]
        warmup_engine(eng, trace())
        ops.reset_kernel_counters()
        outs = eng.run(trace())
        runs[graphs] = ([o.tokens for o in outs], ops.counter_snapshot())
        assert [t.data_ptr() for t in cache_leaves(eng.kv.data)] == ptrs
        if not graphs:
            continue
        assert eng._decode_chunk.info["captured"]
        assert sorted(eng.kv.prefill_graphs) == [6, 9, 20]
        for S, g in eng.kv.prefill_graphs.items():
            assert g.info["captured"], S
            prompt = rng.integers(0, cfg.vocab, (1, S), dtype=np.int32)
            ref = map_cache(torch.clone, eng.kv.data)
            got = eng.kv.write_prefill(params, prompt, 1).clone()
            want, _ = prefill_into_slot(
                params, cfg, torch.as_tensor(prompt, device="cuda"), ref, 1)
            assert torch.equal(got, want) and same(eng.kv.data, ref), S
        tok = rng.integers(0, cfg.vocab, 4).astype(np.int32)
        pos = np.array([20, 3, 9, 30], np.int32)
        for _ in range(2):
            ref = map_cache(torch.clone, eng.kv.data)
            before = eng.kv.data["ssm_state"]["ssm"].clone()
            got = eng._decode_chunk.run(tok, pos).clone()
            want = _decode_chunk_fn(cfg, 4)(
                params, torch.as_tensor(tok[:, None], device="cuda"), ref,
                torch.as_tensor(pos, device="cuda"))
            assert torch.equal(got, want) and same(eng.kv.data, ref)
            assert not torch.equal(eng.kv.data["ssm_state"]["ssm"], before)
            tok, pos = got[-1].cpu().numpy().astype(np.int32), pos + 4
        assert [t.data_ptr() for t in cache_leaves(eng.kv.data)] == ptrs
    assert runs[True] == runs[False]
    assert all(len(t) == 8 for t in runs[True][0])
    launches = runs[True][1]["launches"]
    if fmt == "nmg":
        for k in ("nmg_gemv", "nmg_spmm"):
            assert launches[k] > 0, (k, launches)
        fused = arch == "hymba-1.5b"      # mamba2 has no q/k/v, no mlp.wi
        assert (launches["nmg_qkv"] > 0) == fused, launches
        assert (launches["nmg_ffn"] > 0) == fused, launches
    else:
        assert not any(launches.values()), launches


@pytest.mark.parametrize("arch", SSM_ARCHES)
def test_ssm_decode_kernels_match_plain(arch, monkeypatch):
    """f32 SMOKE, n:m:g 1:4:8 gr16: an admission of 20 tokens (the SpMM;
    two chunks of 16) into slot 1 and 6 decode steps of both slots through
    the kernels, against the same steps fed the same tokens with every
    wrapper swapped for its plain version: logits and every cache leaf
    (the state leaves too) within rtol 1e-4, atol 1e-3."""
    _require_cuda()
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_cache, \
        prefill_into_slot
    from repro_torch.models.transformer import cache_leaves

    cfg, params = _ssm_family(arch, "nmg", dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (1, 20), generator=g, device="cuda",
                         dtype=torch.int32)

    def run(feed=None):
        cache = init_cache(cfg, 2, 40, device="cuda")
        logits, _ = prefill_into_slot(params, cfg, toks, cache, 1)
        outs, fed = [logits], []
        tok = torch.stack([torch.zeros_like(logits[0, 0]).int(),
                           logits[0].argmax().int()])[:, None]
        for i in range(6):
            if feed is not None:
                tok = feed[i]
            fed.append(tok)
            logits, _ = decode_step(params, cfg, tok, cache, torch.tensor(
                [i, 20 + i], device="cuda"))
            outs.append(logits)
            tok = logits.argmax(-1).int()[:, None]
        return outs, fed, cache

    ops.reset_kernel_counters()
    got, fed, cache = run()
    launches = ops.counter_snapshot()["launches"]
    for k in ("nmg_gemv", "nmg_spmm"):
        assert launches[k] > 0, (k, launches)
    for mod, attr, plain in ops.KERNEL_WRAPPERS.values():
        monkeypatch.setattr(mod, attr, getattr(mod, plain))
    want, _, ref = run(fed)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
    for a, b in zip(cache_leaves(cache), cache_leaves(ref)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemv_and_spmm_on_padded_in_proj(dtype):
    """mamba2-370m's ``in_proj`` [1024, 4384] at gr64: its 4384 rows pad to
    4416 in the layout.  The GEMV (M = 4, decode) and the SpMM (N = 32,
    admission), as ``nmg_linear`` calls them, give [M, 4384] (the pad rows
    cut off) and agree with the plain versions; ``out_proj`` [2048, 1024]
    alike."""
    _require_cuda()
    from repro_torch.kernels import ops

    for K, R, M in ((1024, 4384, 4), (1024, 4384, 32), (2048, 1024, 4)):
        w = _card_weight(K, R, dtype)
        assert w.val.shape[0] == -(-R // 64) * 64
        g = torch.Generator(device="cuda").manual_seed(M)
        x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
        ops.reset_kernel_counters()
        got = ops.nmg_linear(x, w)
        kern = "nmg_gemv" if M <= 16 else "nmg_spmm"
        assert ops.counter_snapshot()["launches"][kern] == 1
        assert got.shape == (M, R) and got.dtype == dtype
        want = (x.float() @ w.to_dense().float())
        tol = TOL if dtype == torch.float32 else dict(rtol=2 ** -7,
                                                      atol=2e-3)
        torch.testing.assert_close(got.float(), want, **tol)
        plain = (nmg_gemv.nmg_gemv_plain(w, x.T, out_dtype=dtype,
                                         transpose_out=True) if M <= 16
                 else nmg_spmm.nmg_spmm_plain(w, x.T, out_dtype=dtype,
                                              transpose_out=True))
        torch.testing.assert_close(got.float(), plain.float(), **tol)


@pytest.mark.parametrize("fmt", ["dense", "nmg"])
def test_encdec_chunk_replay_bitwise_eager_over_cross_kv(fmt):
    """bf16 whisper SMOKE, a ``SlotKVCache`` of 4 slots x 40 rows with
    cross K/V of 24 frames: two requests admitted with their frames by
    ``prefill_into_slot(enc_embeds=)``, then the engine's 4-step chunk
    program captured and replayed three times, each replay bitwise the
    eager program on a clone of the cache (tokens and every leaf), with a
    third admission between the first and second replay.  Every leaf
    keeps its storage (``data_ptr``) across admissions, capture and
    replays; an admission rewrites its slot's ``xk`` / ``xv``, decode only
    reads them."""
    _require_cuda()
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import prefill_into_slot
    from repro_torch.models.transformer import cache_leaves, map_cache
    from repro_torch.serve import SlotKVCache
    from repro_torch.serve.engine import _decode_chunk_fn
    from repro_torch.serve.graphs import DecodeGraph

    cfg, params = _new_family("whisper-large-v3", fmt)
    kv = SlotKVCache(cfg, 4, 40, enc_len=24, device="cuda")
    ptrs = [t.data_ptr() for t in cache_leaves(kv.data)]
    rng = np.random.default_rng(0)
    g = torch.Generator(device="cuda").manual_seed(1)

    def admit(slot, S):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)),
                               device="cuda")
        frames = torch.randn(1, 24, cfg.d_model, generator=g,
                             device="cuda").to(cfg.tdtype)
        before = kv.data["xk"][:, slot].clone()
        logits, _ = prefill_into_slot(params, cfg, toks, kv.data, slot,
                                      enc_embeds=frames)
        assert not torch.equal(kv.data["xk"][:, slot], before)
        return int(logits[0].argmax())

    def same(a, b):
        return all(torch.equal(x, y) for x, y in
                   zip(cache_leaves(a), cache_leaves(b)))

    tok = np.zeros(4, np.int32)
    pos = np.zeros(4, np.int32)
    for slot, S in ((0, 12), (2, 7)):
        tok[slot], pos[slot] = admit(slot, S), S
    chunk = DecodeGraph(_decode_chunk_fn(cfg, 4), params, kv.data, 4,
                        name="decode_chunk",
                        pool=torch.cuda.graph_pool_handle())
    chunk.run(tok, pos)                       # the eager run, then capture
    assert chunk.info["captured"]
    for turn in range(3):
        if turn == 1:
            tok[1], pos[1] = admit(1, 9), 9
        ref = map_cache(torch.clone, kv.data)
        cross = [kv.data[n].clone() for n in ("xk", "xv")]
        ops.reset_kernel_counters()
        got = chunk.run(tok, pos).clone()
        replayed = ops.counter_snapshot()
        ops.reset_kernel_counters()
        want = _decode_chunk_fn(cfg, 4)(
            params, torch.as_tensor(tok[:, None], device="cuda"), ref,
            torch.as_tensor(pos, device="cuda"))
        assert torch.equal(got, want) and same(kv.data, ref), turn
        assert replayed == ops.counter_snapshot(), turn
        assert all(torch.equal(kv.data[n], c)
                   for n, c in zip(("xk", "xv"), cross)), turn
        tok, pos = got[-1].cpu().numpy().astype(np.int32), pos + 4
    assert chunk.info["replays"] == 3
    assert [t.data_ptr() for t in cache_leaves(kv.data)] == ptrs
    launches = replayed["launches"]
    if fmt == "nmg":
        for k in ("nmg_gemv", "nmg_qkv"):
            assert launches[k] > 0, (k, launches)
        assert launches["nmg_ffn"] == 0, launches   # whisper's MLP is plain
    else:
        assert not any(launches.values()), launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_at_whisper_encoder_width(dtype):
    """whisper-large-v3's ``mlp.wi`` [1280, 5120] at gr64 over the
    encoder's 1500 frames: ``nmg_linear`` takes the SpMM once and agrees
    with the plain version and with the dense product."""
    _require_cuda()
    from repro_torch.kernels import ops

    w = _card_weight(1280, 5120, dtype)
    g = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn(1500, 1280, generator=g, device="cuda").to(dtype)
    ops.reset_kernel_counters()
    got = ops.nmg_linear(x, w)
    assert ops.counter_snapshot()["launches"]["nmg_spmm"] == 1
    assert got.shape == (1500, 5120) and got.dtype == dtype
    want = x.float() @ w.to_dense().float()
    tol = TOL if dtype == torch.float32 else dict(rtol=2 ** -7, atol=2e-3)
    torch.testing.assert_close(got.float(), want, **tol)
    plain = nmg_spmm.nmg_spmm_plain(w, x.T, out_dtype=dtype,
                                    transpose_out=True)
    torch.testing.assert_close(got.float(), plain.float(), **tol)


# ---------------------------------------------------------------------------
# the paged KV cache and the int8 cache: the paged programs as CUDA graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", [None, "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "minicpm3-4b"])
def test_paged_engine_replay_bitwise_eager(arch, kv):
    """bf16 SMOKE n:m:g served by a paged engine (2 slots x 48 rows, pages
    of 8, prompts 20, 6, 20, 6 sharing nothing, 8 new tokens, chunk 4)
    with graphs and with ``graphs=False``, and by the slot engine: token
    streams equal, replay and eager launch counts equal, the pool's
    storage kept; then an admission and a chunk replayed on the live
    pool, each bitwise its eager program on a clone (logits, tokens,
    every pool leaf, the sink page included).  With ``kv="int8"`` the
    K/V (qwen) or latents (minicpm3) are int8 codes."""
    _require_cuda()
    import dataclasses

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.transformer import cache_leaves, map_cache
    from repro_torch.serve import Request, ServeEngine, warmup_engine
    from repro_torch.serve.cache import _paged_prefill_fn
    from repro_torch.serve.engine import _paged_decode_chunk_fn

    cfg, params = _new_family(arch, "nmg")
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (20, 6, 20, 6)]

    def trace():
        return [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in
                   zip(cache_leaves(a), cache_leaves(b)))

    dev = lambda x: torch.as_tensor(x, device="cuda")   # noqa: E731
    kw = dict(max_slots=2, max_seq_len=48, decode_chunk=4)
    runs = {}
    for name, graphs, paged in (("graph", True, True),
                                ("eager", False, True),
                                ("slot", True, False)):
        eng = ServeEngine(params, cfg, graphs=graphs, paged=paged,
                          page_size=8, **kw)
        ptrs = [t.data_ptr() for t in cache_leaves(eng.kv.data)]
        warmup_engine(eng, trace())
        ops.reset_kernel_counters()
        outs = eng.run(trace())
        runs[name] = ([o.tokens for o in outs], ops.counter_snapshot())
        if name != "graph":
            continue
        assert eng._decode_chunk.info["captured"]
        assert eng._decode_chunk.info["replays"] > 0
        assert all(g.info["captured"] for g in
                   eng.kv.prefill_graphs.values())
        if kv:
            assert any(t.dtype == torch.int8
                       for t in cache_leaves(eng.kv.data))
        pk = eng.kv
        ref = map_cache(torch.clone, pk.data)
        prompt = rng.integers(0, cfg.vocab, (1, 20), dtype=np.int32)
        got = pk.admit(params, prompt, 1).clone()          # a replay
        want = _paged_prefill_fn(cfg, 8, pk.num_pages)(
            params, dev(prompt), ref, dev(pk.table[1]), dev(np.int32(1)),
            dev(np.int32(0)))
        assert torch.equal(got, want) and same(pk.data, ref)
        tok, pos = np.array([0, int(got.argmax())], np.int32), \
            np.array([0, 20], np.int32)
        for _ in range(2):
            assert pk.ensure_writable_range(1, int(pos[1]), 4)
            ref = map_cache(torch.clone, pk.data)
            got = eng._decode_chunk.run(tok, pos, pk.table).clone()
            want = _paged_decode_chunk_fn(cfg, 8, pk.num_pages, 4)(
                params, dev(tok[:, None]), ref, dev(pk.table), dev(pos))
            assert torch.equal(got, want) and same(pk.data, ref)
            tok, pos = got[-1].cpu().numpy().astype(np.int32), pos + 4
        assert [t.data_ptr() for t in cache_leaves(pk.data)] == ptrs
    assert runs["graph"] == runs["eager"]
    assert runs["graph"][0] == runs["slot"][0]
    assert all(len(t) == 8 for t in runs["graph"][0])
    launches = runs["graph"][1]["launches"]
    for k in ("nmg_gemv", "nmg_ffn"):
        assert launches[k] > 0, (k, launches)
    assert (launches["nmg_qkv"] > 0) == (cfg.attn_type == "gqa")


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_tier_programs_replay_bitwise_and_build_nothing(paged):
    """qwen1.5-4b SMOKE, bf16, tiers ``dense,2:4,1:4:8-gr16`` (the FFN
    converted: the sparse tiers' decode runs the fused FFN and the GEMV,
    their admissions the SpMM): ``warm_tiers`` captures every tier's
    decode programs (chunk 4, single step) and admissions, and then three batches under ``set_tier(0)``, ``(2)``
    and ``(1)`` build nothing and replay bitwise an eager engine built on
    that tier's params alone, launch counts included.  Then a fault storm
    over the replayed tier 2: every survivor's tokens bitwise the batch
    served without faults."""
    _require_cuda()
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.models import init_lm
    from repro_torch.serve import FaultConfig, FaultInjector, Request, \
        ServeEngine, trace_events

    cfg = get_smoke("qwen1.5-4b")
    params = init_lm(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (20, 6) * 3]
    kw = dict(max_slots=2, max_seq_len=48, decode_chunk=4)
    if paged:
        kw.update(paged=True, page_size=8)
    # no controller: a manual tier holds
    eng = ServeEngine(params, cfg, tiers=["dense", "2:4", "1:4:8-gr16"],
                      **kw)
    eng.warm_tiers((20, 6))
    built = dict(trace_events())
    progs = list(eng._programs.values()) + list(eng.kv.programs.values())
    assert len(progs) == 3 * 2 + 3 * 2        # (chunk, step), 2 lengths
    assert all(g.info["captured"] for g in progs)
    for t, lo in ((0, 0), (2, 2), (1, 4)):
        def batch():
            return [Request(uid=i, prompt=prompts[i], max_new_tokens=9)
                    for i in (lo, lo + 1)]
        eng.set_tier(t)
        ops.reset_kernel_counters()
        got = [o.tokens for o in eng.run(batch())]
        got_counts = ops.counter_snapshot()
        assert trace_events() == built, t
        ref = ServeEngine(eng.tiers[t].params, cfg, graphs=False, **kw)
        ops.reset_kernel_counters()
        want = [o.tokens for o in ref.run(batch())]
        built = dict(trace_events())     # with the eager engine's builds
        assert got == want, t
        assert got_counts == ops.counter_snapshot(), t
        if t:
            launches = got_counts["launches"]
            for k in ("nmg_gemv", "nmg_ffn", "nmg_spmm"):
                assert launches[k] > 0, (t, k, launches)
            assert launches["nmg_qkv"] == 0
    reqs = [Request(uid=i, prompt=p, max_new_tokens=9)
            for i, p in enumerate(prompts)]
    eng.set_tier(2)
    base = {o.uid: o.tokens for o in eng.run(reqs)}
    eng.faults = FaultInjector(FaultConfig(
        seed=0, spike_prob=0.2, spike_s=(1e-4, 2e-4), error_prob=0.5,
        slow_windows=((1, 3, 2.0),)))
    outs = eng.run(reqs)
    assert eng.stats["fault_retries"] > 0
    assert {o.uid: o.tokens for o in outs} == base
    assert trace_events() == built
    if paged:
        assert eng.kv.alloc.pages_in_use() == 0
