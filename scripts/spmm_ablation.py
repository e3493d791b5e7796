#!/usr/bin/env python3
"""Where the bf16 n:m:g SpMM kernel's time goes, by ablation, on one GPU.

    python3 scripts/spmm_ablation.py

Builds ``src/repro_torch/csrc/nmg_spmm.cu`` as it is (``base``) and with
one phase of its bf16 body cut out per variant, each a textual edit of
the source compiled into ``build/spmm_ablation/``:

  no_window  the staged copies of each token's B window are not issued
  no_gather  the gathered B slab is not built from the window
  no_mma     the tensor-core products are not run
  only_val   only the ``val`` stream through the cp.async ring is left

Every variant is timed as ``chip_smoke.py`` times the kernel (device time
by CUDA events, L2 flushed before each launch, median of 30) at the
serving path's prefill shapes (1:4:8 gr64, bf16, B = x.T, bf16 [N, R]
output), beside a one-element ``zero_`` (the launch floor under this
timing).  A cut variant computes garbage; only its time is read.  The
difference between ``base`` and a variant is the time that phase adds
where it does not overlap the others.  Results go to stdout and to
``chiprun_out/spmm_ablation.json``.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CUT = {
    "no_window": [("  if (staged) {\n    __nv_bfloat16* sx",
                   "  if (false) {\n    __nv_bfloat16* sx")],
    "no_gather": [("build_b<ROWS, THREADS, NP>(gathered(",
                   "if (K < 0) build_b<ROWS, THREADS, NP>(gathered(")],
    "no_mma": [("#pragma unroll\n    for (int kq = 0;",
                "    if (K < 0)\n    for (int kq = 0;")],
}
VARIANTS = {"base": [], **CUT,
            "only_val": CUT["no_window"] + CUT["no_gather"] + CUT["no_mma"]}
# (model, weight, K, R, N): the weights and prompt widths of chip_smoke.py
SHAPES = [("bert", "wi", 768, 3072, 32), ("qwen", "wi", 2560, 13824, 32),
          ("qwen", "wi", 2560, 13824, 64)]


def build(out_dir: Path) -> dict:
    """One nvcc per variant, all started together; {name: CDLL}."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "nmg_spmm.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    return libs


def launcher(lib, w, b, out, ws):
    """A call of one variant's nmg_spmm_launch, as the wrapper makes it
    for bf16 [N, R] output (ws sized for any split count)."""
    import torch

    fn = lib.nmg_spmm_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    K, N = b.shape
    cg = math.comb(w.m, w.n) * w.g
    args = (1, w.val.data_ptr(), w.gather_plan().cols.data_ptr(),
            b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr(),
            ws.data_ptr(), w.canonical_rows(), w.val.shape[0], K,
            w.val.shape[1] * w.val.shape[2], N, w.gr, w.n * cg, w.m * cg, 1,
            1)

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: error {err}")
    return call


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("spmm_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.nmg import dense_to_grouped_nm

    card = cs.nvidia_smi_line()
    libs = build(ROOT / "build" / "spmm_ablation")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    tiny = torch.empty(1, device="cuda")
    result = {"card": card, "floor_ms": cs.time_ms(tiny.zero_, flush),
              "shapes": []}
    print(f"{card}: launch floor {result['floor_ms']:.4f} ms")
    for model, name, K, R, N in SHAPES:
        dense = (torch.randn(K, R, generator=gen, device="cuda")
                 / math.sqrt(K)).to(torch.bfloat16)
        w = dense_to_grouped_nm(dense, 1, 4, 8, gr=64, sparse_dim=0)
        x = torch.randn(N, K, generator=gen, device="cuda").to(torch.bfloat16)
        out = torch.empty(N, R, dtype=torch.bfloat16, device="cuda")
        ws = torch.empty(16, R, N, device="cuda")
        ms = {v: cs.time_ms(launcher(lib, w, x.T, out, ws), flush)
              for v, lib in libs.items()}
        result["shapes"].append({"model": model, "weight": name, "K": K,
                                 "R": R, "N": N, "ms": ms})
        print(f"{model} {name} N={N}: "
              + " ".join(f"{v} {t:.4f}" for v, t in ms.items()) + " ms")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "spmm_ablation.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
