#!/usr/bin/env python3
"""Where the bf16 decode kernels' time goes, by ablation, on one GPU.

    python3 scripts/rows_ablation.py

Builds ``src/repro_torch/csrc/nmg_gemv.cu`` and ``nmg_ffn.cu`` with their
shared row loop ``nmg_rows.cuh`` as they are (``base``) and with one phase
of the ``tc`` body cut out per variant, each a textual edit of the
sources compiled into ``build/rows_ablation/<variant>/``:

  no_gather  the plan entries, the B window and B values are not loaded
             (the gathered B reads as zeros)
  no_mma     the tensor-core products are not run
  no_val     the ``val`` slabs are not copied into the ring
  only_val   only the ``val`` stream through the cp.async ring is left
  empty      none of the three: launch, cluster, part sums, epilogue
  empty_no_reduce  and no cluster barrier or cross-part store either
  trivial    the body returns at once (launch and block scheduling)
  trivial_no_smem  and the launch asks for no dynamic shared memory

and, on the ``base`` build, with another plan than the wrappers'
(``row_plan``):

  parts1     one part (no cluster; every slab in one block)
  per1       one slab a part (up to eight parts)
  per3       about three slabs a part (fewer parts and blocks)
  rows32     32-row tiles (twice the blocks, two warps each)
  rows16     16-row tiles (four times the blocks, one warp each)

Every variant is timed as ``chip_smoke.py`` times the kernels (device time
by CUDA events, L2 flushed before each launch, median of 30) through the
wrappers at the six decode cases of the serving path (1:4:8 gr64, bf16,
B = x.T, bf16 [M, R] output, M = 4), beside the library call of each case
(``torch.matmul`` on the densified weight, plus ``silu(u) * v`` for the
FFN) and a one-element ``zero_`` (the launch floor under this timing).  A
cut variant computes garbage; only its time is read.  The difference
between ``base`` and a variant is the time that phase adds where it does
not overlap the others.  Results go to stdout and to
``chiprun_out/rows_ablation.json``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

NO_GATHER = [("  if (wp > 0) {\n    for (int i = threadIdx.x; i < NW * ns;",
              "  if (K < 0) {\n    for (int i = threadIdx.x; i < NW * ns;"),
             ("  if (wp > 0) {\n    mma_tile::cp_async_wait",
              "  if (K < 0) {\n    mma_tile::cp_async_wait"),
             ("const int ca = k_begin + s < k_end ? gc[s] : K;",
              "const int ca = K;"),
             ("const int cb = k_begin + s2 < k_end ? gc[s2] : K;",
              "const int cb = K;")]
NO_MMA = [("#pragma unroll\n      for (int w = 0; w < kPos; ++w) {",
           "      if (K < 0)\n      for (int w = 0; w < kPos; ++w) {")]
NO_VAL = [("    if (j < nk) issue(j);", "    if (K < 0) issue(j);"),
          ("if (kt + kStages - 1 < nk) issue(kt + kStages - 1);",
           "if (K < 0) issue(kt + kStages - 1);")]
EMPTY = NO_GATHER + NO_MMA + NO_VAL
NO_REDUCE = [("  if (parts > 1) cluster_arrive_relaxed();", ""),
             ("  if (parts > 1) cluster_wait();\n", ""),
             ("*cluster.map_shared_rank(dst, owner) = v;", "*dst = v;"),
             ("  if (parts > 1) {   // every part's sums have arrived",
              "  if (K < 0) {")]
TRIVIAL = [("  namespace cg = cooperative_groups;\n",
            "  namespace cg = cooperative_groups;\n  if (K > 0) return;\n")]
NO_SMEM = [("smem, stream>>>", "0, stream>>>"),
           ("cfg.dynamicSmemBytes = smem;", "cfg.dynamicSmemBytes = 0;")]
VARIANTS = {"base": [], "no_gather": NO_GATHER, "no_mma": NO_MMA,
            "no_val": NO_VAL, "only_val": NO_GATHER + NO_MMA,
            "empty": EMPTY, "empty_no_reduce": EMPTY + NO_REDUCE,
            "trivial": TRIVIAL, "trivial_no_smem": TRIVIAL + NO_SMEM}
LIBS = ("nmg_gemv", "nmg_ffn")
# (model, kernel, weight, K, R): the six cases of the decode targets
CASES = [("bert", "gemv", "wi", 768, 3072), ("bert", "qkv", "wq", 768, 768),
         ("qwen", "gemv", "mlp.wo", 6912, 2560),
         ("qwen", "gemv", "attn.wo", 2560, 2560),
         ("qwen", "qkv", "wq", 2560, 2560),
         ("qwen", "ffn", "wi", 2560, 13824)]
M = 4


def build(out_dir: Path) -> dict:
    """One nvcc per (variant, library), all started together;
    {variant: {library: CDLL}}."""
    from repro_torch.kernels import _build

    names = ("nmg_rows.cuh", "mma_tile.cuh") + tuple(f"{lib}.cu"
                                                     for lib in LIBS)
    sources = {n: (_build.CSRC / n).read_text() for n in names}
    procs = {}
    for name, edits in VARIANTS.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        texts = dict(sources)
        for old, new in edits:
            hit = [n for n, t in texts.items() if old in t]
            if not hit:
                raise RuntimeError(f"{name}: the sources no longer have "
                                   f"{old!r}")
            for n in hit:
                texts[n] = texts[n].replace(old, new)
        for n, t in texts.items():
            (d / n).write_text(t)
        for lib in LIBS:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                   str(d / f"lib{lib}.so"), str(d / f"{lib}.cu")]
            procs[name, lib] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    libs: dict = {}
    for (name, lib), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}/{lib}:\n{log}")
        libs.setdefault(name, {})[lib] = ctypes.CDLL(
            str(out_dir / name / f"lib{lib}.so"))
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("rows_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.nmg import dense_to_grouped_nm
    from repro_torch.kernels import _build, nmg_fused, nmg_gemv

    card = cs.nvidia_smi_line()
    libs = build(ROOT / "build" / "rows_ablation")
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    tiny = torch.empty(1, device="cuda")
    result = {"card": card, "floor_ms": cs.time_ms(tiny.zero_, flush),
              "M": M, "cases": []}
    print(f"{card}: launch floor {result['floor_ms']:.4f} ms")

    def weight(K, R):
        dense = (torch.randn(K, R, generator=gen, device="cuda")
                 / math.sqrt(K)).to(bf16)
        return dense_to_grouped_nm(dense, 1, 4, 8, gr=64, sparse_dim=0)

    plan = nmg_gemv.row_plan

    def split(per_of):
        def p(gr, m, KN, dtype):
            base = plan(gr, m, KN, dtype)
            nslab = math.ceil(KN / 64)
            per = per_of(nslab)
            return dataclasses.replace(base, per=per,
                                       parts=math.ceil(nslab / per))
        return p

    def rows(r):
        def p(gr, m, KN, dtype):
            return dataclasses.replace(plan(gr, m, KN, dtype), rows=r)
        return p

    plans = {"parts1": split(lambda n: n),
             "per1": split(lambda n: math.ceil(n / 8)),
             "per3": split(lambda n: math.ceil(n / min(8, math.ceil(n / 3)))),
             "rows32": rows(32), "rows16": rows(16)}

    for model, kernel, wname, K, R in CASES:
        ws = [weight(K, R)] + ([weight(K, R), weight(K, R)]
                               if kernel == "qkv" else [])
        x = torch.randn(M, K, generator=gen, device="cuda").to(bf16)
        wd = torch.cat([w.to_dense() for w in ws], dim=1)
        if kernel == "gemv":
            def run(w=ws[0]):
                return nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16,
                                         transpose_out=True)

            def library():
                return torch.matmul(x, wd)
        elif kernel == "qkv":
            def run():
                return nmg_fused.nmg_qkv(ws, x.T, out_dtype=bf16,
                                         transpose_out=True)

            def library():
                return torch.matmul(x, wd)
        else:
            def run(w=ws[0]):
                return nmg_fused.nmg_ffn(w, x.T, out_dtype=bf16,
                                         transpose_out=True)

            def library():
                u, v = torch.matmul(x, wd).chunk(2, dim=-1)
                return F.silu(u) * v
        ms = {"library": cs.time_ms(library, flush)}
        for name, pair in libs.items():
            _build._LIBS.update(pair)
            ms[name] = cs.time_ms(run, flush)
        _build._LIBS.update(libs["base"])
        for name, p in plans.items():
            nmg_gemv.row_plan = nmg_fused.row_plan = p
            try:
                ms[name] = cs.time_ms(run, flush)
            finally:
                nmg_gemv.row_plan = nmg_fused.row_plan = plan
        KN = ws[0].val.shape[1] * ws[0].val.shape[2]
        p0 = plan(64, M, KN, bf16)
        result["cases"].append({"model": model, "kernel": kernel,
                                "weight": wname, "K": K, "R": R,
                                "plan": dataclasses.asdict(p0), "ms": ms})
        print(f"{model} {kernel} {wname} (rows {p0.rows}, parts {p0.parts}, "
              f"per {p0.per}): "
              + " ".join(f"{v} {t:.4f}" for v, t in ms.items()) + " ms")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "rows_ablation.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
