#!/usr/bin/env python3
"""Where ``nm_mask``'s time goes, by ablation, on one GPU.

    python3 scripts/nm_mask_ablation.py

Builds ``src/repro_torch/csrc/nm_mask.cu`` as it is (``base``) and with one
phase cut out, or one design choice reversed, per variant, each a textual
edit of the source compiled into ``build/nm_mask_ablation/<variant>/``:

  vec_no_store     vector body: the mask words are not stored
  vec_u1           vector body: one chunk in flight a thread, not up to 4
  vec_count        vector body: bf16 m = 16 and 32 count each element's
                   rank (m compare-and-add pairs) instead of sorting keys
  vec_sort         vector body: bf16 m <= 8 sort keys too, instead of
                   counting
  staged_no_store  staged body: no write-out of the staged mask bytes
                   (the 4-byte words; the few head and tail bytes stay)
  staged_no_rank   staged body: no sorting network (every mask byte 0)
  staged_loads_only  staged body: only the loads of the run into its
                   blocks' rows in shared memory (no ranking, no write-out)
  empty            every body returns at once (launch and block scheduling)
  kth_tree         the n-th key picked by a tree of selects on the bits of
                   n - 1 instead of a chain of selects on r == n - 1 (which
                   the compiler turns into an indexed load from local memory)
  no_prefetch      staged body: the next tile's loads are issued after this
                   tile's write-out, not before its ranking

Every variant is timed as ``chip_smoke.py`` times the kernels (device time
by CUDA events, L2 flushed before each launch, median of 30) through the
wrapper at the training path's cases (bf16): 2:4 on the stacked and
per-layer ``mlp.wo`` / ``attn.wo``, 16:32 and 5:20 on the stacked
``mlp.wo``, and 2:4 on the stacked ``mlp.wo`` one element into its storage
(the staged body).  Beside them: a one-element ``zero_`` (the launch floor
under this timing) and ``x != 0``, one PyTorch elementwise launch that
moves the same bytes as the mask (reads x once, writes one byte an
element).  A cut variant computes garbage; only its time is read.  With
``--parent FILE`` an earlier ``nm_mask.cu`` (with the same
``nm_mask_launch``) is built and timed beside them as ``parent``.  Results
go to stdout and to ``chiprun_out/nm_mask_ablation.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

VEC_NO_STORE = [("      store_words<E / 4>(out + c * E, w);",
                 "      if (n < 0) store_words<E / 4>(out + c * E, w);")]
VEC_U1 = [("constexpr int U = NV >= 4 ? 1 : 4 / NV;", "constexpr int U = 1;")]
VEC_COUNT = [("constexpr bool kSort = M >= 16 && sizeof(Key) == 4;",
              "constexpr bool kSort = false;")]
VEC_SORT = [("constexpr bool kSort = M >= 16 && sizeof(Key) == 4;",
             "constexpr bool kSort = sizeof(Key) == 4;")]
STAGED_NO_STORE = [("    const int nw = (cur.L - h2) / 4;\n",
                    "    const int nw = g.n < 0 ? (cur.L - h2) / 4 : 0;\n")]
STAGED_NO_RANK = [("      if (g.n > 0) {\n        const Key kth",
                   "      if (g.n < 0) {\n        const Key kth")]
STAGED_LOADS_ONLY = STAGED_NO_STORE + [(
    "    for (int q = tid; q < cur.np; q += kThreads) {",
    "    for (int q = tid; q < (g.n < 0 ? cur.np : 0); q += kThreads) {")]
_XV = "  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);"
EMPTY = [(_XV, "  if (n >= 0) return;\n" + _XV),
         ("  extern __shared__ __align__(16) unsigned char smem[];",
          "  if (g.n >= 0) return;\n"
          "  extern __shared__ __align__(16) unsigned char smem[];"),
         ("  __shared__ __align__(16) Key cmp[kLongChunk];",
          "  if (n >= 0) return;\n"
          "  __shared__ __align__(16) Key cmp[kLongChunk];")]
KTH_TREE = [(
    "  Key kth = k[0];\n"
    "#pragma unroll\n"
    "  for (int r = 1; r < MB; ++r)\n"
    "    if (r == n - 1) kth = k[r];\n"
    "  return kth;\n",
    "#pragma unroll\n"
    "  for (int w = pow2_at_least(MB) / 2, b = 0; w >= 1; w /= 2, ++b) {\n"
    "#pragma unroll\n"
    "    for (int i = 0; i < w; ++i) {\n"
    "      const Key lo = 2 * i < MB ? k[2 * i] : Key(0);\n"
    "      const Key hi = 2 * i + 1 < MB ? k[2 * i + 1] : Key(0);\n"
    "      k[i] = ((n - 1) >> b) & 1 ? hi : lo;\n"
    "    }\n"
    "  }\n"
    "  return k[0];\n")]
NO_PREFETCH = [("      nxt = run_of(x, row0, blk0, tn * kBpt, kBpt, g);\n"
                "      fetch(nxt);\n",
                "      nxt = run_of(x, row0, blk0, tn * kBpt, kBpt, g);\n"),
               ("    __syncthreads();                     // rows and obuf "
                "are free again\n",
                "    __syncthreads();\n    fetch(nxt);\n")]
VARIANTS = {"base": [], "vec_no_store": VEC_NO_STORE, "vec_u1": VEC_U1,
            "vec_count": VEC_COUNT, "vec_sort": VEC_SORT,
            "staged_no_store": STAGED_NO_STORE,
            "staged_no_rank": STAGED_NO_RANK,
            "staged_loads_only": STAGED_LOADS_ONLY, "empty": EMPTY,
            "kth_tree": KTH_TREE, "no_prefetch": NO_PREFETCH}
# (name, rows, K, n, m, storage offset in elements)
CASES = [("mlp.wo", 12 * 3072, 768, 2, 4, 0),
         ("attn.wo", 12 * 768, 768, 2, 4, 0),
         ("mlp.wo[layer]", 3072, 768, 2, 4, 0),
         ("attn.wo[layer]", 768, 768, 2, 4, 0),
         ("mlp.wo", 12 * 3072, 768, 16, 32, 0),
         ("mlp.wo", 12 * 3072, 768, 5, 20, 0),
         ("mlp.wo+1", 12 * 3072, 768, 2, 4, 1)]


def build(out_dir: Path, parent: Path | None) -> dict:
    """One nvcc per variant, all started together; {variant: CDLL}."""
    from repro_torch.kernels import _build

    source = (_build.CSRC / "nm_mask.cu").read_text()
    variants = dict(VARIANTS)
    if parent is not None:
        variants["parent"] = []
    procs = {}
    for name, edits in variants.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        text = source if name != "parent" else parent.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has "
                                   f"{old!r}")
            text = text.replace(old, new)
        (d / "nm_mask.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               str(d / "libnm_mask.so"), str(d / "nm_mask.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / name / "libnm_mask.so"))
    return libs


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="an earlier nm_mask.cu to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("nm_mask_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import nm_mask as nmk

    card = cs.nvidia_smi_line()
    libs = build(ROOT / "build" / "nm_mask_ablation", args.parent)
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    tiny = torch.empty(1, device="cuda")
    result = {"card": card, "floor_ms": cs.time_ms(tiny.zero_, flush),
              "cases": []}
    print(f"{card}: launch floor {result['floor_ms']:.4f} ms")
    for wname, R, K, n, m, off in CASES:
        flat = torch.randn(R * K + off, generator=gen, device="cuda").to(bf16)
        x = flat[off:].view(R, K)
        _build._LIBS["nm_mask"] = libs["base"]
        plan = nmk.nm_mask_plan(x, n, m)
        b, by = cs.bound(x.numel() * 3, 2 * m * x.numel(), cs.F32_FLOPS)
        ms = {"ne_same_bytes": cs.time_ms(lambda: x != 0, flush)}
        for name, lib in libs.items():
            _build._LIBS["nm_mask"] = lib
            ms[name] = cs.time_ms(lambda: nmk.nm_mask(x, n, m), flush)
        _build._LIBS["nm_mask"] = libs["base"]
        result["cases"].append({"weight": wname, "R": R, "K": K,
                                "n_m": f"{n}:{m}", "offset": off, **plan,
                                "bound_ms": b, "bound_by": by, "ms": ms})
        print(f"{wname} [{R}, {K}] {n}:{m} ({plan['body']}, grid "
              f"{plan['grid']}, bound {b:.4f} {by}): "
              + " ".join(f"{v} {t:.4f}" for v, t in ms.items()) + " ms")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "nm_mask_ablation.json").write_text(
        json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
