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
Fused QKV against three single launches: bitwise.  The fused gated FFN
against the GEMV followed by PyTorch's own activation and multiply:
bitwise for silu (the kernel's epilogue replays PyTorch's CUDA silu);
for gelu's tanh approximation within one rounding step of the output
type (``tanhf`` and the polynomial may round differently from
PyTorch's kernel)."""

import pytest
import torch

from repro_torch.core.nmg import dense_to_grouped_nm
from repro_torch.kernels import nmg_fused, nmg_gemv, nmg_spmm

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=2e-4)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false); runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _weights(K, R, dtype, count=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [dense_to_grouped_nm(torch.randn(K, R, generator=g), 1, 4, 8,
                                gr=64, sparse_dim=0).to("cuda", dtype)
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


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _require_cuda()
    (w,) = _weights(768, 768, torch.bfloat16)
    with pytest.raises(ValueError):
        nmg_gemv.nmg_gemv(w, torch.randn(768, 17, device="cuda",
                                         dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        nmg_gemv.nmg_gemv(w, torch.randn(768, 4, device="cuda"))  # f32 B
    w16 = dense_to_grouped_nm(torch.randn(768, 64), 1, 4, 8, gr=16,
                              sparse_dim=0).to("cuda", torch.bfloat16)
    with pytest.raises(ValueError):
        nmg_spmm.nmg_spmm(w16, torch.randn(768, 32, device="cuda",
                                           dtype=torch.bfloat16))


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
