#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch/CUDA versions; the
   port's CUDA kernels are built from ``src/repro_torch/csrc`` (one nvcc
   per source, started together).
2. Kernel phase, bf16 at the shapes of the served models (bert-base-sten
   and qwen1.5-4b, 1:4:8 gr64; at starcoder2-15b the GEMV at mlp.wi, R =
   24576, and mlp.wo, K = 24576, the fused QKV and the SpMM at mlp.wo; at
   gemma2-9b the fused QKV, the FFN with gelu at the packed [3584, 28672]
   wi, held against the GEMV + gelu-tanh · v within the card tests'
   bound, and the SpMM at that wi; at paligemma-3b the fused QKV over
   its MQA segments 2048 + 256 + 256, the gelu FFN at [2048, 32768], the
   GEMV at K = 16384 and the SpMM at an image request's N = 288; at
   minicpm3-4b the silu FFN at [2560, 12800] and the GEMV at mlp.wo, K =
   6400, and attn.wo; at moonshot-v1-16b-a3b the GEMV and SpMM at
   attn.wo [2048, 2048] and the fused QKV at R = 6144; at mamba2-370m the
   GEMV and SpMM at ssm.in_proj [1024, 4384], whose rows pad to 4416 in
   the layout, and ssm.out_proj [2048, 1024]; at hymba-1.5b the fused QKV
   over 1600 + 320 + 320, the silu FFN at the packed [1600, 11008] wi,
   the GEMV at attn.wo and mlp.wo, K = 5504, and the SpMM at both mlp
   weights; at whisper-large-v3 the GEMV at mlp.wi [1280, 5120], mlp.wo
   and wq [1280, 1280], the fused QKV over 3 x 1280 and the SpMM at those
   three at N = 32 and at the encoder's N = 1500) and of the training
   path (``nm_mask`` 2:4 on the stacked and per-layer ``mlp.wo`` /
   ``attn.wo``, 16:32, 5:20, special values and a
   misaligned view, bitwise, each naming the body it took;
   ``matmul_threshold``
   at 1024 tokens x 768 x 3072): each kernel's wrapper against its plain
   PyTorch version on the same inputs (fused QKV bitwise against three
   GEMV launches, the fused gated FFN bitwise against the GEMV followed by
   PyTorch's silu and multiply; every redesigned kernel also bitwise
   against a second launch, and the SpMM's bf16 [N, R] epilogue bitwise
   against its f32 output cast and transposed), then timed with CUDA
   events against the plain version and a library yardstick
   (``torch.matmul`` on the densified weight, plus ``silu(u) * v`` for the
   FFN; the port never calls it).  The decode kernels (GEMV, QKV, FFN, at
   M = 1, 4, 8, 16) report the body and plan they ran (``tc`` at gr64),
   and the tensor-core bodies their registers a thread (``-Xptxas -v``)
   and shared memory a block.  The device L2 is flushed before every
   timed launch: on the serving path a layer's weights are cold when its
   turn comes.
   a. Every gr the reference takes, at bert-base-sten's ``wi`` / ``wq``:
      the GEMV, fused QKV, FFN and SpMM at gr 1, 16 and 24 (the ``tc``
      decode body at 16, the ``general`` one at 1 and 24; the SpMM through
      the GEMV kernel over 16-column chunks) with the same checks.
3. Main paths, each with the launch counts zeroed right before its run
   and read right after:
   a. full-width bert-base-sten (12 layers, d_model 768, d_ff 3072, vocab
      30522, bf16) with seeded random weights serves 8 requests through
      the port's ServeEngine — dense, n:m:g 1:4:8 gr64 on the FFN (fig11's
      setting), n:m:g on FFN and attention (``attn=True``), and the same
      at gr16 (the format the parity tests use on the CPU);
   b. full-width, full-depth qwen1.5-4b (40 layers, d_model 2560, d_ff
      6912 gated, QKV bias, vocab 151936, bf16, seeded random weights)
      serves the same trace dense and n:m:g 1:4:8 gr64 with ``attn=True``;
      every decode-shaped FFN goes through the fused FFN kernel.
   Each configuration is served twice: replaying the engine's programs
   as CUDA graphs (the default: one admission prefill per prompt length
   and the decode chunk) and with ``graphs=False`` (eager), each engine
   warmed first with the trace's prompt lengths, which builds its
   programs (trace events: ``slot_prefill`` 4, ``decode_chunk`` 1, and
   none added by the measured run); token streams and launch counts
   (replays included) must be equal, TTFT p50/p99 is reported both
   ways, and each length's replayed admission is held bitwise against
   eager ``prefill_into_slot``.  Each ``attn=True`` model's prefill and
   decode logits through the kernels are then held against the same
   steps through the plain versions (bert at gr64 and gr16).  The graph
   phase then holds, in all six configurations, the replayed 8-step
   chunk and single step bitwise against the eager programs across an
   admission, and reports the chunk's wall and device time eager and
   replayed, the capture and instantiation cost and the graph pool's
   size.  The prefill phase does the same for the admission programs
   of bert and qwen (dense and ``attn=True`` gr64) at S = 16, 24, 32
   and 64: replay bitwise eager into slots 1 and 3, counts equal, wall
   replayed and eager, device time, capture cost and pool per length.
   c. full-width bert-base-sten trains (bf16, batch 8 x 128 tokens,
      AdamW, GMP): (a) the CLI's default masked path through
      ``repro_torch.launch.train`` (``--sparsity 0.75 --gmp iterative``,
      magnitude-pruned FixedMask leaves, 20 steps); (b) the library API
      with the inline threshold 0.5 on the dense ``mlp.wi`` (the fused
      matmul-threshold kernel in every forward) and NMSparsifier(2, 4)
      FixedMask leaves on ``mlp.wo`` / ``attn.wo`` (the nm_mask kernel at
      the build and at every GMP recompute), 10 steps.  Each run goes
      through the graph trainer (the CLI's default: the step captured once
      as a CUDA graph and replayed, recomputes eager between replays,
      chunks of 5 steps) and through the host loop (``--host-loop``), and
      the two must agree bit for bit (losses, gradient norms, params,
      masks, moments, step counter); the graph run's launch counts are
      the main path's.  After each run, chunks of 5 steps with no
      recompute are timed replayed and eager (and profiled last).  Run
      (b)'s first step is repeated from the same state through the plain
      versions (loss and ``mlp.wi`` gradient compared), also from fresh
      models at three more seeds.
      Then checkpoint and resume at full width: run (a)'s model over 6
      steps with a checkpoint every 3, then a run resumed from a copy of
      its step-3 checkpoint in a temporary directory must end bit for bit
      where it ended.
   Phases (d), (e), (h), (i) and (j) serve some models at a cut depth
   (``PHASE_DEPTH``, printed on their lines): starcoder2-15b 10 of 40
   layers, gemma2-9b 5 of 21 pairs, minicpm3-4b 8 of 62,
   moonshot-v1-16b-a3b 12 of 48 (in (h)), mamba2-370m 8 of 48,
   hymba-1.5b 8 of 32, whisper-large-v3 6 + 6 of 32 + 32; every check
   of each phase still runs, at full width.  Phases (m) and (n) run
   qwen1.5-4b at 4 layers and (n) moonshot-v1-16b-a3b at 2.
   d. full-width starcoder2-15b (40 layers, d_model 6144, GQA
      48/4 heads, non-gated gelu d_ff 24576, vocab 49152) and gemma2-9b
      (42 layers as 21 local/global pairs, window 4096, softcaps 50 / 30,
      post-norms, gated gelu d_ff 14336, tied head, vocab 256000), bf16,
      seeded random weights, in a process of its own (``python3
      chip_smoke.py --families``, started after (b): the earlier phases'
      params, graphs, pools and profiler sessions are not in it): init and
      n:m:g 1:4:8 gr64 ``attn=True`` conversion (seconds, peak memory),
      then dense and n:m:g served through the engine as in (a) and (b)
      (graphs and eager, streams and counts equal, each length's
      admission replayed bitwise eager), the 8-step chunk replayed
      bitwise eager (wall eager and replayed, the replay's CUDA-event
      span), per-token p50 beside the byte bound of the weights a decode
      step reads, and the n:m:g logits held against the plain versions
      (before gemma2's logit softcap, which saturates most random logits;
      under its tied head each step's own column held apart and the rest
      within 5% of their RMS).  Then one gemma2 request across the
      window: a 4160-token prompt (the local rings of 4096 rows wrap at
      admission) and 32 new tokens through the graphs, its last logits
      held against the port's own full forward and the plain versions,
      its cache row by row against the classic prefill of its tokens, and
      controls that must fail those checks (the reference's classic ring
      layout; no post-norms; silu for gelu).
   e. full-width, full-depth paligemma-3b (18 layers, d_model 2048, MQA
      8/1 heads of 256, gated gelu d_ff 16384, tied 257216-row head) and
      minicpm3-4b (62 layers, d_model 2560, MLA over 40 heads with a
      256-wide latent, gated silu d_ff 6400, vocab 73448), bf16, seeded
      random weights, in a process of its own (``python3 chip_smoke.py
      --vlm-mla``, after (d)), through (d)'s sequence (the fused QKV
      asserted at GQA models only: MLA has no q/k/v group).  Then
      paligemma's image request: 256 seeded patch embeddings admitted by
      ``prefill_into_slot(prefix_embeds=)`` into an engine's cache with a
      32-token prompt, 32 tokens decoded by the engine's decode programs
      (replayed); and minicpm3's 1024 + 32-token request through the
      engine.  Each request's last step is held against one full
      ``forward`` over everything fed (logits under the rule above, and
      every layer's attention output at the last position within 0.1 of
      its RMS: with random weights the context reaches the logits
      little) and against the plain versions; controls that must fail
      the check: the patch embeddings fed causally (no prefix mask), and
      the cache's ``kr`` rows zeroed (MLA's RoPE term dropped).
   h. full-width moonshot-v1-16b-a3b (48 layers, d_model
      2048, MHA 16 x 128, a mixture of 64 experts top-6 of d_expert 1408
      in every layer, capacity factor 1.25, vocab 163840; 28.0 B params,
      56 GB whole; served at 24 of its layers) and arctic-480b at SMOKE (4 experts top-2 beside its dense
      residual MLP; its full width needs more than one card), bf16,
      seeded random weights, in a process of its own (``python3
      chip_smoke.py --moe``, after (e)), through (d)'s sequence (n:m:g
      converts attention alone: the serving globs match no expert; no
      fused FFN: a MoE layer has no ``mlp.wi``), each admission length
      replayed bitwise eager and timed, dense and n:m:g, and the MoE
      checks in place of the logit parity (near-ties in the router make
      two runs take other experts somewhere in the layers): (1) layer by
      layer, each layer fed the plain run's input, the attention output
      within 0.1 of its RMS, the router's probabilities within 0.01 of
      theirs, and every expert the kernels take that plain does not a
      top-k of plain's probabilities within ``ROUTE_MARGIN``, a constant
      (the kernels' experts relabelled must fall outside it); (2) end to
      end with each MoE layer's experts from the plain run pinned in the
      kernels' run (``models/moe.py:route_log``), prefill of 32 and 16
      tokens and 4 decode steps: the logits under the 5% rule, every MoE
      layer's output at the last position within 0.1 of its RMS, and
      every pinned choice a top-k of the kernels' own router within
      ``PIN_MARGIN``, a constant; (3) the same with a shuffled copy of
      the routes pinned must fail (2) and fall outside ``PIN_MARGIN``;
      (4) a 64-token admission's dropped slots per layer, each count the
      capacity rule's.
   i. full-width mamba2-370m (48 Mamba2 SSD layers, d_model
      1024, state 128, heads of 64, chunk 256, vocab 50280; no attention,
      no MLP) and hymba-1.5b (32 layers, each GQA 25/5 heads of 64 over a
      2048-token window beside a Mamba2 mixer of state 16, mixed as (a +
      s) / 2, gated silu d_ff 5504, vocab 32001), bf16, seeded random
      weights, in a process of its own (``python3 chip_smoke.py --ssm``,
      after (h)), through (d)'s sequence and the prefill phase (each
      admission length replayed bitwise eager and timed); the n:m:g copy
      of mamba2 converts ``ssm.in_proj`` / ``ssm.out_proj`` through a
      ``SparsityBuilder`` plan (the serving globs match none of its
      leaves), hymba's ``sparsify_for_serving(attn=True)`` (its mixer
      stays dense).  The step's byte bound counts the recurrent state
      (read and written once a step) beside the weights.  Then one long
      request each through the graphs of a one-slot engine (mamba2 4096 +
      32 tokens, 16 chunks of the scan; hymba 4160 + 32 at 4224 rows, past
      its window, so its local layers attend over the window of a
      full-length cache): the slot's state after a replayed admission
      bitwise the classic prefill's, every step's logits held against a
      teacher-forced full ``forward`` and the plain versions, and each
      layer's mixer outputs (attention and SSM apart) at the last step
      within 0.1 of the forward's RMS; controls that must fail that
      check: the last step decoded from a zeroed ``ssm`` state, and
      hymba's attention without its window.
   j. full-width whisper-large-v3 (32 encoder layers over a
      request's 1500 frames, 32 decoder layers each with cross-attention,
      d_model 1280, MHA 20 x 64, non-gated gelu d_ff 5120, vocab 51866),
      bf16, seeded random weights and frames, in a process of its own
      (``python3 chip_smoke.py --encdec``, after (i)).  Dense and n:m:g
      1:4:8 gr64 ``attn=True`` (16 leaf kinds: the encoder's, the
      decoder's and its ``xattn``) each serve the trace through a loop of
      this script's own over a ``SlotKVCache(enc_len=1500)`` (the engine
      takes no encoder inputs): admissions eager by
      ``prefill_into_slot(enc_embeds=)``, the engine's 8-step chunk
      program replayed and eager (streams and counts equal); the chunk
      replayed bitwise eager across an admission; an admission's wall
      time and device span (and its encoder's); the n:m:g logits held
      against the plain versions; the device span of a step's 32
      cross-attention sublayers beside the cross K/V's bytes, which the
      step's byte bound counts.  Then one full-context request (224 + 224
      tokens at 448 rows, beside another request in a second slot): its
      cross K/V bitwise a classic prefill's, every step's logits held
      against one teacher-forced ``forward``, each decoder layer's self-
      and cross-attention output at the last step within 0.1 of the
      forward's RMS; controls that must fail the cross-attention rows:
      the slot's cross K/V zeroed, the other slot's copied in, and a
      causal encoder in the forward.
   k. the int8 KV cache and paged serving, in a process of its own
      (``python3 chip_smoke.py --kvcache``, after (j)): full-width,
      full-depth qwen1.5-4b, dense and n:m:g 1:4:8 gr64 ``attn=True``,
      and minicpm3-4b n:m:g at 16 of its 62 layers, bf16, seeded random
      weights.  (k1) the trace
      through ``ServeEngine(paged=True, page_size=16)`` beside the slot
      engine: tokens and launch counts equal, ``paged_prefill`` 4 and
      ``paged_decode_chunk`` 1 built in the warm-up and none in the
      measured run; at the cache level (``paged_programs``) the four
      admissions' logits and every slot's rows read through the page
      table bitwise the slot cache's, again after one chunk, and each
      admission length, three chunks (an admission after the second) and
      two single steps replayed bitwise eager.  n:m:g: (k2) 8 requests
      sharing a 64-token prefix, sharing on and off, tokens equal and
      prompt tokens shared; (k3) half the default pages: every request
      finished with (k1)'s tokens, with a deferred admission or a
      preemption.  (k4) ``kv_cache_dtype="int8"`` (qwen's K/V, minicpm3's
      latents) in both layouts: tokens equal, ``paged_programs`` bitwise;
      the fixed check (``fixed_check``): a 64 + 32-token teacher-forced
      request, every step's logits with the int8 cache bitwise those over
      a bf16 cache into which every write was fake-quantized, and the
      control (a bare ``.to(torch.int8)`` for the quantizer) fails it;
      codes at +-127 and the distance from a bf16 cache reported.  (k5)
      per-token p50 and TTFT p50 replayed of slot and paged, bf16 and
      int8, cache bytes, a paged chunk's device span beside the slot
      chunk's, and four 1536-token prompts at 2048 rows through bf16 and
      int8 slot caches beside the step's byte bound (weights and the
      cache rows read).
   l. SLO-controlled serving, in a process of its own (``python3
      chip_smoke.py --slo``, after (k)): full-width, full-depth
      qwen1.5-4b, bf16, seeded random weights, through
      ``ServeEngine(slo=SLOConfig(tpot_ms=14), tiers=("dense", "2:4",
      "1:4:8-gr64"), faults=...)``, 4 slots of 96 rows, chunk 8 (shrunk
      to 4), every tier's decode programs and admissions captured by
      ``warm_tiers``.  (l1) a bursty trace (24 requests at 6/s, 16 more at
      once at 1 s) with seeded faults (spikes, retried errors, a x3 slow
      window) and the flight recorder on: every request terminal, a tier
      switch, tokens from two tiers, retries, no program built after
      ``warm_tiers``, the sparse tiers' GEMV, FFN and SpMM launched, the
      Chrome trace valid; (l2) each tier bitwise a plain engine on its
      params, the control (tier 2 against dense) differing; (l3) the
      storm at 1:4:8-gr64 on the paged engine, survivors bitwise, no page
      left; (l4) the recorder changing no token and no count; (l5) the
      serve CLI with tiers, faults and a trace, its one-shot mode and the
      trainer with a trace, at bert-base-sten's width.
   m. the static checker (``repro_torch.check``), in a process of its own
      (``python3 chip_smoke.py --check <tpot ms>``, after (l)): (m1) the
      device model (``launch/hw.py``'s H100 entry) equal to the card's
      properties, R7 silent; (m2) the R6 estimator's shared memory a
      block equal to the libraries' own figure in every GEMV, fused QKV,
      FFN and SpMM case of the kernel phase (held there, in
      :func:`rows_resources` / :func:`spmm_resources`) and at a tuned
      ``gemv_cuda`` entry; (m3) qwen1.5-4b at full width, 4 of its 40
      layers (``PHASE_DEPTH``), ``attn=True`` 1:4:8 gr64, bf16: every
      serve program traced and captured, no ERROR (R3 ignored: bf16
      norms run in f32); (m4) the differential at the check config: no
      ``DIFF``, the GEMV and SpMM launched; (m5) ``serve --engine --check
      --arrival-gap 0.02`` with an SLO 1.5 x bert's dense p50 and ``train
      --check --steps 2`` at bert-base-sten's width, both exit 0, no
      request shed before it arrives; (m6) every rule's trigger fixture
      on the card (R4's capture failing at its host read) yields its
      rule, every clean one none, and ``preflight`` returns 1 on the R1
      trigger.
   n. distribution (``repro_torch.dist``, ``launch/steps.py``), in a
      process of its own (``python3 chip_smoke.py --dist``, after (m)),
      under ``torch.distributed`` with NCCL at world size 1 (its group
      started from a ``HashStore``; NCCL takes one rank a card) over a
      (1, 1) ("data", "model") mesh, params as DTensors: (n1) full-width
      bert-base-sten, bf16, 50% magnitude masks, two sharded train steps
      at remat "none" (twice) and "full" against the unsharded
      ``launch/train.py:make_train_step`` (losses and gnorm within 1e-3,
      weights within 2 lr a step, masks equal; bitwise expected and
      reported; remat held bitwise where two "none" runs agree bitwise);
      (n2) qwen1.5-4b at full width, 4 of its 40 layers, 1:4:8 gr64
      ``attn=True``: the sharded prefill step of [2, 64] prompts and 8
      sharded decode steps, tokens equal to the unsharded ``prefill`` /
      ``decode_step``'s and logits under the 5% rule, the GEMV, fused
      QKV, FFN and SpMM launched through the DTensor boundary (counted
      from 0 right before); (n3) moonshot-v1-16b-a3b at full width, 2
      layers: the forward with ``impl="shmap"`` and with
      ``combine="scatter"`` against gather / pjit under the 5% rule; (n4)
      the four collectives on NCCL, each bitwise its input (or the
      ``ef_step`` payload scattered).  Multi-rank results are the CPU
      tests' (gloo ranks).
   o. the dry-run (``launch/dryrun.py``, ``launch/cost_analysis.py``),
      in (n)'s process after its NCCL group is destroyed: (o1) two
      production cells at full width and depth on a fake process group
      of 256 ranks over the 16x16 mesh (``mamba2-370m`` and
      ``qwen1.5-4b --opt sparse=nmg``, both ``decode_32k``), each ok, its
      roofline terms printed; (o2) qwen1.5-4b at full width, 4 of its 40
      layers (``PHASE_DEPTH``), 1:4:8 gr64 ``attn=True``, its decode
      step at ``decode_32k``'s per-device shape on that mesh (batch 8,
      2048 cache rows) at world size 1: counted on meta, then run on the
      card (CUDA events, median of 20, L2 not flushed): the measured time
      at least the roofline bound, and the GEMV, fused QKV and FFN counts
      of the count equal to the launches of one step on the card.
   f. the programming model (``repro_torch.sten``): (s1) the library at
      the model's shapes, bf16 — ``NMTensor.from_dense`` through
      ``nm_mask``, ``sten.linear`` / ``sten.matmul`` on n:m:g weights
      through the GEMV and SpMM routes, the fused ``sparsified_op``
      through ``matmul_threshold``, each held to its plain version, and
      the CSR/COO products against dense; (s2) full-width bert-base-sten
      under a plan (masked-dense n:m:g ``mlp.wi``, 2:4 ``mlp.wo``, 2:4 on
      the ``mlp.act`` intermediate, a gradient format on ``attn.wo``):
      five library-API training steps and an eval forward with ``mlp.wo``
      an NMTensor (the lossless NMTensor -> FixedMaskTensor route), held
      to the same run through the plain versions.
   g. tuning (``repro_torch.tune``): ``python -m repro_torch.tune
      --quick`` in a subprocess (its decision lines, its table loaded);
      at bert ``mlp.wi`` / ``mlp.wo`` and qwen ``attn.wq``, packed
      ``mlp.wi`` and ``mlp.wo`` (bf16 1:4:8 gr64) the tuned decode config
      and SpMM split held against the plain versions, and the GEMV and
      SpMM device times at M = 8, 12, 16, 17, 20, 24, 32 with the
      kernels' own configs and the tuned ones, with each crossover; then
      bert and qwen ``attn=True`` gr64 served by an engine warmed with
      ``warmup_engine(..., tune=True)`` beside one with default routing:
      every routed counter ``[table]``, ``predict_route`` equal to one
      replay's counters (decode chunk and each admission), tokens equal
      where no route or config moved and logits within the serve
      phase's bound of the default routing's, a replay bitwise unchanged
      under another table activated after capture, and per-token p50 and
      TTFT p99 tuned and default in turns.
4. Summary: a compact ``{"serve": ..., "train": ...}`` line, a
   ``{"kernels": [...]}`` line (one entry per TPU kernel, naming the body
   and gr it was timed at: serving kernels at qwen1.5-4b shapes with
   launches from its n:m:g run, and their launches on each n:m:g run of
   (d), (e), (h), (i), (j) and (k); training kernels at bert-base-sten
   training shapes with launches from run (b)'s graph trainer),
   the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
   Every ``torch.profiler`` session runs after all unprofiled timing
   (one session slows every later launch of the process).
   Details go to ``chiprun_out/chip_smoke.json``.

Any failure raises and the script exits non-zero; without CUDA it exits 2
before printing any result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.hw import H100  # noqa: E402 (after the path)

HBM_BYTES_PER_S = H100["hbm_bw"]          # H100 SXM device memory
BF16_FLOPS = H100["peak_flops_bf16"]      # dense bf16 tensor-core peak
F32_FLOPS = H100["peak_flops_f32"]        # f32 outside the tensor cores
REPS = 30
SPIN_CYCLES = 4_000_000        # ~2 ms at the H100's ~1.98 GHz boost clock
#: seconds since the script started at the end of each of its phases
#: (printed on the "smoke timeline" line and kept in chip_smoke.json)
T_START = time.perf_counter()
LAPS = {}


def lap(name: str) -> None:
    LAPS[name] = round(time.perf_counter() - T_START, 1)

# each served model's projections as [K, N] weights (sparse along K):
# which of them the decode GEMV and the prefill SpMM take on its path (the
# SpMM every shape unless ``spmm`` names some), the prompt widths its SpMM
# sees, the packed gated weight of the fused FFN and its activation, the
# q/k/v widths of the fused QKV launch (default three of ``wq``'s), and
# the decode widths (default DECODE_M)
MODELS = {
    "bert": dict(shapes={"wi": (768, 3072), "wo_ffn": (3072, 768),
                         "wq": (768, 768)},
                 gemv=("wi", "wo_ffn", "wq"), spmm_n=(17, 24, 32, 64, 128),
                 ffn=None),
    "qwen": dict(shapes={"wi": (2560, 13824), "wo_ffn": (6912, 2560),
                         "wq": (2560, 2560)},
                 gemv=("wo_ffn", "wq"), spmm_n=(24, 32, 64), ffn="wi"),
    # the widths the GEMV and SpMM meet first here: K = 24576 (mlp.wo),
    # R = 24576 (the non-gated gelu mlp.wi), the gelu FFN at [3584, 28672]
    "starcoder2": dict(shapes={"wi": (6144, 24576), "wo_ffn": (24576, 6144),
                               "wq": (6144, 6144)},
                       qkv=(6144, 512, 512), gemv=("wi", "wo_ffn"),
                       spmm=("wo_ffn",), spmm_n=(32, 64), ffn=None,
                       decode_m=(4, 16)),
    "gemma2": dict(shapes={"wi": (3584, 28672), "wq": (3584, 4096)},
                   qkv=(4096, 2048, 2048), gemv=(), spmm=("wi",),
                   spmm_n=(32, 64), ffn="wi", act="gelu",
                   decode_m=(1, 4, 16)),
    # paligemma-3b: MQA segments 2048 + 256 + 256, the gelu FFN at the
    # packed [2048, 32768] wi, the GEMV at K = 16384 (mlp.wo), the SpMM at
    # a prefix request's width (256 patch rows + a 32-token prompt)
    "paligemma": dict(shapes={"wi": (2048, 32768), "wo_ffn": (16384, 2048),
                              "wq": (2048, 2048)},
                      qkv=(2048, 256, 256), gemv=("wo_ffn",), spmm=("wi",),
                      spmm_n=(288,), ffn="wi", act="gelu",
                      decode_m=(4, 16)),
    # minicpm3-4b: no q/k/v group (MLA's latent projections stay dense, no
    # "wq" here, so no QKV case), attn.wo [2560, 2560], mlp.wo K = 6400,
    # the silu FFN at the packed [2560, 12800] wi
    "minicpm3": dict(shapes={"wi": (2560, 12800), "wo_ffn": (6400, 2560),
                             "wo": (2560, 2560)},
                     gemv=("wo_ffn", "wo"), spmm=(), ffn="wi", act="silu",
                     decode_m=(4, 16)),
    # moonshot-v1-16b-a3b: n:m:g converts attention alone (the experts are
    # moe.*, which the serving globs do not match), MHA 16 x 128: attn.wo
    # and each q/k/v segment K = N = 2048, the QKV group R = 6144; the
    # admissions' SpMM at attn.wo (q/k/v take it alike)
    "moonshot": dict(shapes={"wq": (2048, 2048), "wo": (2048, 2048)},
                     gemv=("wo",), spmm=("wo",), spmm_n=(24, 32, 64),
                     ffn=None, decode_m=(4, 16)),
    # mamba2-370m: n:m:g converts the mixer's projections (a builder plan
    # on *ssm.in_proj / *ssm.out_proj); in_proj's 4384 rows pad to 4416
    # in the layout and are cut back in the output
    "mamba2": dict(shapes={"in_proj": (1024, 4384),
                           "out_proj": (2048, 1024)},
                   gemv=("in_proj", "out_proj"), spmm_n=(32,), ffn=None,
                   decode_m=(4,)),
    # hymba-1.5b: GQA 25/5 heads of 64 (q/k/v 1600 + 320 + 320), attn.wo,
    # the silu FFN at the packed [1600, 11008] wi, mlp.wo K = 5504; its
    # mixer stays dense (the serving globs match no ssm.* leaf)
    "hymba": dict(shapes={"wq": (1600, 1600), "wo": (1600, 1600),
                          "wi": (1600, 11008), "wo_ffn": (5504, 1600)},
                  qkv=(1600, 320, 320), gemv=("wo", "wo_ffn"),
                  spmm=("wo_ffn", "wi"), spmm_n=(32,), ffn="wi",
                  act="silu", decode_m=(4,)),
    # whisper-large-v3: MHA 20 x 64 (q/k/v 1280 each; xattn.wq and
    # xattn.wo at decode alike), the non-gated gelu mlp.wi [1280, 5120],
    # mlp.wo K = 5120; the SpMM at a decoder prompt's width and at the
    # encoder's 1500 frames (its every projection, and xattn.wk / wv)
    "whisper": dict(shapes={"wi": (1280, 5120), "wo_ffn": (5120, 1280),
                            "wq": (1280, 1280)},
                    gemv=("wi", "wo_ffn", "wq"), spmm_n=(32, 1500),
                    ffn=None, decode_m=(4,)),
    # qwen1.5-4b's FFN in phase (l)'s 2:4 tier (2:4:4 gr64, the FFN only):
    # the GEMV at mlp.wo, the fused FFN at the packed wi at decode (and an
    # admission of 16 tokens), the SpMM at wi for admissions of 32 and 64
    "qwen24": dict(shapes={"wi": (2560, 13824), "wo_ffn": (6912, 2560)},
                   gemv=("wo_ffn",), spmm=("wi",), spmm_n=(32, 64),
                   ffn="wi", decode_m=(4, 16), fmt=(2, 4, 4)),
}
DECODE_M = (1, 4, 8, 16)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, flush) -> float:
    """Device time of ``fn``: median of REPS CUDA-event timings, the L2
    flushed before each launch (a 64 MiB write evicts the 50 MB L2).  A
    ~2 ms device spin before each timed launch keeps the device busy while
    the host enqueues the launch, so the events bracket device work only
    and not the host's launch cost (that is ``host_ms``)."""
    import torch

    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def host_ms(fn, n: int = 50) -> float:
    """Host time to issue one call of ``fn`` (checks, ctypes, launch), with
    the device kept busy so no call waits for it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES * 20)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return t


def timings(kernel, plain, library, flush) -> dict:
    """Device times of the kernel, its plain version and the library
    yardstick (None where no single PyTorch call computes the function),
    and the host cost of issuing the kernel."""
    return {"ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
            "library_ms": None if library is None
            else time_ms(library, flush),
            "host_ms": host_ms(kernel)}


def bound(nbytes: int, flops: int, rate: float = BF16_FLOPS) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def storage_bytes(w) -> int:
    cols = w.gather_plan().cols
    return w.val.numel() * w.val.element_size() + cols.numel() * 4


def _ptxas_entry(lib: str, entry: str) -> dict:
    """Registers a thread and static shared memory of one kernel entry,
    from ``-Xptxas -v``'s report of the library's build."""
    from repro_torch.kernels import _build

    res = _build.ptxas_usage(lib, entry)
    if res is None:
        raise RuntimeError(f"ptxas log of {lib} names no entry {entry}")
    return res


#: (m2): every case whose shared memory a block the R6 estimator was held
#: to the library's own figure at (kernel, K, width, bytes)
R6_HELD = []


def r6_held(kernel: str, w, width: int, est: dict, lib_bytes: int) -> int:
    """Hold the R6 estimate of ``w`` at ``width`` to the library's figure
    (phase (m2)); returns the bytes."""
    assert est["error"] is None and est["dynamic_bytes"] == lib_bytes, \
        (kernel, w.dense_shape, width, est, lib_bytes)
    R6_HELD.append((kernel, int(w.dense_shape[0]), int(width), lib_bytes))
    return lib_bytes


def spmm_resources(w, b) -> dict:
    """The bf16 SpMM body's block at this shape: warps, n8 tiles, column
    tiles, K splits, registers a thread (ptxas) and shared memory a block
    (its dynamic ring and B buffers), the R6 estimate held to it."""
    from repro_torch.check.static_pass import spmm_smem
    from repro_torch.kernels import _build
    from repro_torch.tune.table import device_kind

    fn = _build.load("nmg_spmm").nmg_spmm_tc_plan
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    fn.restype = None
    plan = (ctypes.c_int * 6)()
    fn(w.val.shape[0], b.shape[1], w.val.shape[1] * w.val.shape[2], w.gr,
       b.data_ptr(), b.stride(0), b.stride(1), plan)
    warps, nt8, col_tiles, splits, smem, staged = list(plan)
    r6_held("nmg_spmm", w, b.shape[1],
            spmm_smem(w, b.dtype, b.shape[1], device_kind()), smem)
    # the kernel's template arguments: n8 tiles, warps along the rows
    res = _ptxas_entry("nmg_spmm",
                       f"nmg_spmm_tc_kernelILi{nt8}ELi{warps // 2}E")
    return {"warps": warps, "n8_tiles": nt8, "col_tiles": col_tiles,
            "splits": splits, "staged": bool(staged),
            "registers": res["registers"],
            "smem_bytes": smem + res["static_smem_bytes"]}


def rows_resources(lib: str, w, b, config=None) -> dict:
    """The decode body the wrappers pick for ``w`` against B (its plan from
    ``row_plan``), with, for the ``tc`` body, registers a thread (ptxas)
    and dynamic shared memory a block of its bf16-output entry, the R6
    estimate held to it."""
    from repro_torch.check.static_pass import gemv_smem
    from repro_torch.kernels import _build
    from repro_torch.kernels.nmg_gemv import chunk_geometry, row_plan
    from repro_torch.tune.table import device_kind

    KN = w.val.shape[1] * w.val.shape[2]
    p = row_plan(w.gr, b.shape[1], KN, b.dtype, config)
    out = {"body": p.body, "gr": w.gr, "tile_rows": p.rows, "parts": p.parts,
           "slabs_per_part": p.per}
    if p.body != "tc":
        return out
    nw = 2 if lib == "nmg_ffn" else 1
    fn = _build.load("nmg_gemv").nmg_rows_tc_smem_bytes
    fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3)
    fn.restype = ctypes.c_int
    res = _ptxas_entry(lib, f"{lib}_tc_kernelILi{p.nt8}ELi{p.rows // 16}E"
                       "13__nv_bfloat16")
    dynamic = fn(p.rows, nw, p.nt8, p.per, p.parts, b.data_ptr(),
                 b.stride(0), b.stride(1), *chunk_geometry(w),
                 min(b.shape[1], 16))
    r6_held(lib, w, b.shape[1], gemv_smem(w, b.dtype, b.shape[1],
                                          device_kind(), ffn=nw == 2),
            dynamic)
    return {**out, "warps": p.rows // 16, "n8_tiles": p.nt8,
            "registers": res["registers"],
            "smem_bytes": dynamic + res["static_smem_bytes"]}


def matmul_threshold_resources() -> dict:
    """The bf16 matmul_threshold body's registers a thread (ptxas) and
    shared memory a block (its ring, reused by the epilogue)."""
    from repro_torch.kernels import _build

    fn = _build.load("matmul_threshold").matmul_threshold_tc_smem_bytes
    fn.restype = ctypes.c_int
    res = _ptxas_entry("matmul_threshold", "matmul_threshold_tc_kernel")
    return {"registers": res["registers"],
            "smem_bytes": fn() + res["static_smem_bytes"]}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(gen, model: str) -> list:
    import torch

    from repro_torch.core.nmg import dense_to_grouped_nm
    from repro_torch.kernels import nmg_fused, nmg_gemv, nmg_spmm

    spec = MODELS[model]
    shapes = spec["shapes"]
    fmt = spec.get("fmt", (1, 4, 8))
    bf16 = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def weight(K, N):
        dense = (torch.randn(K, N, generator=gen, device="cuda")
                 / math.sqrt(K)).to(bf16)
        return dense_to_grouped_nm(dense, *fmt, gr=64, sparse_dim=0)

    W = {name: weight(K, N) for name, (K, N) in shapes.items()}
    qkv = []
    if "wq" in shapes:
        Dq = shapes["wq"][0]
        widths = spec.get("qkv", (shapes["wq"][1],) * 3)
        qkv = [W["wq"]] + [weight(Dq, n) for n in widths[1:]]
    decode_m = spec.get("decode_m", DECODE_M)
    act = spec.get("act", "silu")
    dense_of = {id(w): w.to_dense() for w in list(W.values()) + qkv}
    cases = []

    def x_of(M, K):
        return torch.randn(M, K, generator=gen, device="cuda").to(bf16)

    def case(kernel, wname, K, N, M, err, tol, fns, nbytes, flops, **kw):
        b, t = bound(nbytes, flops)
        cases.append(dict(kernel=kernel, model=model, weight=wname, K=K, N=N,
                          M=M, fmt=":".join(map(str, fmt)), max_abs_err=err,
                          tol=tol, **kw,
                          **timings(*fns, flush), bound_ms=b, bound_by=t))

    # GEMV (decode): the main path calls it with B = x.T, a bf16 epilogue
    # and the transposed [M, N] output
    for name in spec["gemv"]:
        w = W[name]
        K, N = shapes[name]
        for M in decode_m:
            x = x_of(M, K)
            got32 = nmg_gemv.nmg_gemv(w, x.T, transpose_out=True)
            ref32 = nmg_gemv.nmg_gemv_plain(w, x.T, transpose_out=True)
            err32 = (got32 - ref32).abs().max().item()
            tol32 = 1e-4 * max(1.0, ref32.abs().max().item())
            got = nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16,
                                    transpose_out=True)
            # the bf16 epilogue is one cast of the f32 sum, so the bf16
            # output lies within one rounding of the output (2**-8 of its
            # largest magnitude) of the plain version's unrounded f32 sum,
            # on top of the f32 bound.  (The plain version's own bf16
            # output rounds separately: where the two f32 sums straddle a
            # rounding boundary the bf16 outputs differ by a whole step.)
            assert torch.equal(got, got32.to(bf16)), \
                f"GEMV bf16 epilogue differs ({name}, M={M})"
            err16 = (got.float() - ref32).abs().max().item()
            tol16 = 2 ** -8 * ref32.abs().max().item() + tol32
            assert err32 <= tol32 and err16 <= tol16, (name, M, err32, err16)
            assert torch.equal(got, nmg_gemv.nmg_gemv(
                w, x.T, out_dtype=bf16, transpose_out=True)), \
                f"GEMV launches disagree ({name}, M={M})"
            wd = dense_of[id(w)]
            case("nmg_gemv", name, K, N, M, err32, tol32,
                 (lambda: nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16,
                                            transpose_out=True),
                  lambda: nmg_gemv.nmg_gemv_plain(w, x.T, out_dtype=bf16,
                                                  transpose_out=True),
                  lambda: torch.matmul(x, wd)),
                 storage_bytes(w) + x.numel() * 2 + M * N * 2,
                 2 * w.val.numel() * M, max_abs_err_bf16_out=err16,
                 bitwise_relaunch=True,
                 **rows_resources("nmg_gemv", w, x.T))

    # fused QKV: one launch over three segments, bitwise equal to three
    wqkv = torch.cat([dense_of[id(w)] for w in qkv], dim=1) if qkv else None
    for M in decode_m if qkv else ():
        x = x_of(M, Dq)
        fused = nmg_fused.nmg_qkv(qkv, x.T, out_dtype=bf16,
                                  transpose_out=True)
        for f, w in zip(fused, qkv):
            seq = nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16,
                                    transpose_out=True)
            assert torch.equal(f, seq), "fused QKV differs from 3 launches"
        again = nmg_fused.nmg_qkv(qkv, x.T, out_dtype=bf16,
                                  transpose_out=True)
        assert all(torch.equal(a, f) for a, f in zip(again, fused)), \
            f"fused QKV launches disagree (M={M})"
        plain32 = nmg_fused.nmg_qkv_plain(qkv, x.T, transpose_out=True)
        got32 = nmg_fused.nmg_qkv(qkv, x.T, transpose_out=True)
        err32 = max((g - p).abs().max().item()
                    for g, p in zip(got32, plain32))
        tol32 = 1e-4 * max(1.0, max(p.abs().max().item() for p in plain32))
        assert err32 <= tol32, ("qkv", M, err32)
        case("nmg_qkv", "wq|wk|wv", Dq, sum(widths), M, err32, tol32,
             (lambda: nmg_fused.nmg_qkv(qkv, x.T, out_dtype=bf16,
                                        transpose_out=True),
              lambda: nmg_fused.nmg_qkv_plain(qkv, x.T, out_dtype=bf16,
                                              transpose_out=True),
              lambda: torch.matmul(x, wqkv)),
             sum(storage_bytes(w) for w in qkv) + x.numel() * 2
             + M * sum(widths) * 2, 2 * sum(w.val.numel() for w in qkv) * M,
             bitwise_vs_3_gemv=True, bitwise_relaunch=True,
             **rows_resources("nmg_gemv", qkv[0], x.T))

    # fused gated FFN (decode) on the packed [D, 2F] weight: f32 output
    # against the plain version; the bf16 output the main path takes
    # against the sequential CUDA path (GEMV, PyTorch's activation, mul):
    # bitwise for silu, for gelu within tests/test_torch_cuda.py's bound
    # (the kernel's tanh is its own)
    if spec["ffn"] is not None:
        w = W[spec["ffn"]]
        K, N2 = shapes[spec["ffn"]]
        Fh = N2 // 2
        wd = dense_of[id(w)]
        act_f = nmg_fused.act_fn(act)

        def library(x):
            u, v = torch.matmul(x, wd).chunk(2, dim=-1)
            return act_f(u) * v

        for M in decode_m:
            x = x_of(M, K)
            got32 = nmg_fused.nmg_ffn(w, x.T, act=act, transpose_out=True)
            ref32 = nmg_fused.nmg_ffn_plain(w, x.T, act=act,
                                            transpose_out=True)
            err32 = (got32 - ref32).abs().max().item()
            tol32 = 1e-4 * max(1.0, ref32.abs().max().item())
            assert err32 <= tol32, ("ffn", M, err32)
            fused = nmg_fused.nmg_ffn(w, x.T, act=act, out_dtype=bf16,
                                      transpose_out=True)
            u, v = nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16,
                                     transpose_out=True).chunk(2, dim=-1)
            seq = act_f(u) * v
            if act == "silu":
                assert torch.equal(fused, seq), \
                    "fused FFN differs from GEMV + silu + mul"
                seq_err = 0.0
            else:
                seq_err = (fused.float() - seq.float()).abs().max().item()
                torch.testing.assert_close(fused.float(), seq.float(),
                                           atol=1e-6, rtol=2 ** -7)
            assert torch.equal(fused, nmg_fused.nmg_ffn(
                w, x.T, act=act, out_dtype=bf16, transpose_out=True)), \
                f"fused FFN launches disagree (M={M})"
            case("nmg_ffn", spec["ffn"], K, N2, M, err32, tol32,
                 (lambda: nmg_fused.nmg_ffn(w, x.T, act=act, out_dtype=bf16,
                                            transpose_out=True),
                  lambda: nmg_fused.nmg_ffn_plain(w, x.T, act=act,
                                                  out_dtype=bf16,
                                                  transpose_out=True),
                  lambda: library(x)),
                 storage_bytes(w) + x.numel() * 2 + M * Fh * 2,
                 2 * w.val.numel() * M, bitwise_vs_sequential=act == "silu",
                 bitwise_relaunch=True, act=act, max_abs_err_vs_seq=seq_err,
                 **rows_resources("nmg_ffn", w, x.T))

    # SpMM (prefill): B = x.T with N prompt tokens, at every shape the main
    # path gives it.  The f32 [R, N] output against the plain version and
    # against a second launch (bitwise); the main path's form (one cast to
    # bf16, written [N, R]) bitwise against the f32 output cast and
    # transposed, and timed as the main path calls it (``ms``), beside the
    # f32 [R, N] form (``ms_f32_out``, the form of the earlier slices'
    # times)
    for name in spec.get("spmm", shapes):
        w, (K, R) = W[name], shapes[name]
        for Ntok in spec["spmm_n"]:
            x = x_of(Ntok, K)
            got = nmg_spmm.nmg_spmm(w, x.T)
            ref = nmg_spmm.nmg_spmm_plain(w, x.T)
            err = (got - ref).abs().max().item()
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            assert err <= tol, (name, Ntok, err)
            assert torch.equal(got, nmg_spmm.nmg_spmm(w, x.T)), \
                f"SpMM launches disagree ({name}, N={Ntok})"
            yt = nmg_spmm.nmg_spmm(w, x.T, out_dtype=bf16,
                                   transpose_out=True)
            assert torch.equal(yt, got.to(bf16).T), \
                f"SpMM bf16 [N, R] epilogue differs ({name}, N={Ntok})"
            wd = dense_of[id(w)]
            case("nmg_spmm", name, K, R, Ntok, err, tol,
                 (lambda: nmg_spmm.nmg_spmm(w, x.T, out_dtype=bf16,
                                            transpose_out=True),
                  lambda: nmg_spmm.nmg_spmm_plain(w, x.T, out_dtype=bf16,
                                                  transpose_out=True),
                  lambda: torch.matmul(x, wd)),
                 storage_bytes(w) + x.numel() * 2 + R * Ntok * 2,
                 2 * w.val.numel() * Ntok, bitwise_relaunch=True,
                 ms_f32_out=time_ms(lambda: nmg_spmm.nmg_spmm(w, x.T), flush),
                 body="spmm_tc", gr=w.gr, **spmm_resources(w, x.T))
    del flush
    return cases


# ---------------------------------------------------------------------------
# phase 2a: every gr the reference takes
# ---------------------------------------------------------------------------

ANY_GR = (1, 16, 24)


def any_gr_phase(gen) -> list:
    """The decode kernels and the SpMM at gr 1, 16 and 24, at bert-base-sten's
    ``wi`` ([768, 3072], 1:4:8, bf16; F = 1536 when read as a packed gated
    weight, a multiple of each gr) and its ``wq`` (three of them for the
    fused QKV launch).  gr 16 takes the ``tc`` decode body, gr 1 and 24 the
    ``general`` one; the SpMM routes all three through the GEMV kernel over
    16-column chunks.  Each result against its plain version (f32 output,
    the tolerance of the kernel phase), bitwise against a second launch,
    fused QKV bitwise against three GEMV launches, the FFN bitwise against
    the GEMV followed by PyTorch's silu and multiply, and the SpMM's bf16
    [N, R] output bitwise against its f32 output cast and transposed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.nmg import dense_to_grouped_nm
    from repro_torch.kernels import nmg_fused, nmg_gemv, nmg_spmm

    bf16 = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    K, R = 768, 3072
    cases = []

    def weight(rows, gr):
        dense = (torch.randn(K, rows, generator=gen, device="cuda")
                 / math.sqrt(K)).to(bf16)
        return dense_to_grouped_nm(dense, 1, 4, 8, gr=gr, sparse_dim=0)

    def close(got, ref, what):
        err = (got - ref).abs().max().item()
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        assert err <= tol, (what, err, tol)
        return err, tol

    for gr in ANY_GR:
        w = weight(R, gr)
        qkv = [weight(K, gr) for _ in range(3)]
        wd = w.to_dense()
        for M in (1, 4, 16):
            x = torch.randn(M, K, generator=gen, device="cuda").to(bf16)
            err, tol = close(nmg_gemv.nmg_gemv(w, x.T, transpose_out=True),
                             nmg_gemv.nmg_gemv_plain(w, x.T,
                                                     transpose_out=True),
                             ("gemv", gr, M))
            y = nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16, transpose_out=True)
            assert torch.equal(y, nmg_gemv.nmg_gemv(
                w, x.T, out_dtype=bf16, transpose_out=True)), ("gemv", gr, M)
            fused = nmg_fused.nmg_qkv(qkv, x.T, out_dtype=bf16,
                                      transpose_out=True)
            for f, wq in zip(fused, qkv):
                assert torch.equal(f, nmg_gemv.nmg_gemv(
                    wq, x.T, out_dtype=bf16, transpose_out=True)), \
                    ("qkv vs 3 gemv", gr, M)
            close(torch.cat(nmg_fused.nmg_qkv(qkv, x.T, transpose_out=True),
                            1),
                  torch.cat(nmg_fused.nmg_qkv_plain(qkv, x.T,
                                                    transpose_out=True), 1),
                  ("qkv", gr, M))
            ffn = nmg_fused.nmg_ffn(w, x.T, out_dtype=bf16,
                                    transpose_out=True)
            u, v = y.chunk(2, dim=-1)
            assert torch.equal(ffn, F.silu(u) * v), ("ffn vs gemv", gr, M)
            assert torch.equal(ffn, nmg_fused.nmg_ffn(
                w, x.T, out_dtype=bf16, transpose_out=True)), ("ffn", gr, M)
            close(nmg_fused.nmg_ffn(w, x.T, transpose_out=True),
                  nmg_fused.nmg_ffn_plain(w, x.T, transpose_out=True),
                  ("ffn", gr, M))
            if M == 4:
                b, by = bound(storage_bytes(w) + x.numel() * 2 + M * R * 2,
                              2 * w.val.numel() * M)
                cases.append(dict(
                    kernel="nmg_gemv", model="bert-anygr", weight="wi", K=K,
                    N=R, M=M, max_abs_err=err, tol=tol, bound_ms=b,
                    bound_by=by,
                    **rows_resources("nmg_gemv", w, x.T),
                    **timings(lambda: nmg_gemv.nmg_gemv(
                        w, x.T, out_dtype=bf16, transpose_out=True),
                        lambda: nmg_gemv.nmg_gemv_plain(
                            w, x.T, out_dtype=bf16, transpose_out=True),
                        lambda: torch.matmul(x, wd), flush)))
        for Ntok in (17, 32):
            x = torch.randn(Ntok, K, generator=gen, device="cuda").to(bf16)
            got = nmg_spmm.nmg_spmm(w, x.T)
            err, tol = close(got, nmg_spmm.nmg_spmm_plain(w, x.T),
                             ("spmm", gr, Ntok))
            assert torch.equal(got, nmg_spmm.nmg_spmm(w, x.T)), \
                ("spmm relaunch", gr, Ntok)
            yt = nmg_spmm.nmg_spmm(w, x.T, out_dtype=bf16, transpose_out=True)
            assert torch.equal(yt, got.to(bf16).T), ("spmm [N, R]", gr, Ntok)
            if Ntok == 32:
                b, by = bound(storage_bytes(w) + x.numel() * 2
                              + R * Ntok * 2, 2 * w.val.numel() * Ntok)
                cases.append(dict(
                    kernel="nmg_spmm", model="bert-anygr", weight="wi", K=K,
                    N=R, M=Ntok, max_abs_err=err, tol=tol, bound_ms=b,
                    bound_by=by,
                    **rows_resources("nmg_gemv", w, x.T[:, :16]),
                    **timings(lambda: nmg_spmm.nmg_spmm(
                        w, x.T, out_dtype=bf16, transpose_out=True),
                        lambda: nmg_spmm.nmg_spmm_plain(
                            w, x.T, out_dtype=bf16, transpose_out=True),
                        lambda: torch.matmul(x, wd), flush)))
    del flush
    return cases


# ---------------------------------------------------------------------------
# phase 2b: the training kernels against their plain versions
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_TOKENS = TRAIN_BATCH * TRAIN_SEQ
THRESHOLD = 0.5


def nm_mask_resources(x, n: int, m: int) -> dict:
    """The ``nm_mask`` body, grid and threads a launch on x takes (and the
    staged body's network slots), its entry's registers a thread (ptxas)
    and shared memory a block (static and dynamic)."""
    import torch

    from repro_torch.kernels import nm_mask as nmk

    plan = nmk.nm_mask_plan(x, n, m)
    t = "f" if x.dtype == torch.float32 else "13__nv_bfloat16"
    entry = {"vector": f"nm_mask_vec_kernelI{t}Li{m}E",
             "staged": f"nm_mask_staged_kernelI{t}Li{plan['slots']}E",
             "long": f"nm_mask_long_kernelI{t}E"}[plan["body"]]
    res = _ptxas_entry("nm_mask", entry)
    return {"body": plan["body"], "grid": plan["grid"],
            "threads": plan["threads"], "slots": plan["slots"],
            "registers": res["registers"],
            "smem_bytes": res["static_smem_bytes"] + plan["smem_bytes"]}


#: magnitudes at the edges of nm_mask's rank rule
SPECIAL = (0.0, -0.0, 1e-40, -1e-40, 2e-39, -2e-39, 1.1754943508222875e-38,
           float("inf"), float("-inf"), float("nan"), 1.0, -0.5, 2.0)


def special_values(shape):
    """bf16 values drawn from SPECIAL, mostly zeros and subnormals, so that
    blocks hold ties among them."""
    import torch

    g = torch.Generator().manual_seed(17)
    p = torch.ones(len(SPECIAL))
    p[:6] = 4.0
    idx = torch.multinomial(p, shape[0] * shape[1], replacement=True,
                            generator=g)
    return torch.tensor(SPECIAL)[idx].reshape(shape).to("cuda",
                                                        torch.bfloat16)


def train_kernel_phase(gen) -> list:
    """The training kernels at run (b)'s shapes, bf16, L2 flushed.
    ``nm_mask`` 2:4 on the stacked leaves run (b) masks along their last
    axis at its recomputes ([12 * 3072, 768] ``mlp.wo``, [12 * 768, 768]
    ``attn.wo``) and on one layer of each (the per-layer build), 16:32 and
    5:20 on the stacked ``mlp.wo``, 2:4 on special values (subnormals,
    NaN, +-0, +-inf) and on the stacked ``mlp.wo`` one element into its
    storage (a misaligned view), each bitwise against its plain version
    and reporting the body it took (``vector``, ``staged`` or ``long``);
    no single PyTorch call computes the n:m mask, so its library time is
    None (``topk`` + ``scatter_`` is timed beside the 2:4 cases for
    reference only).  ``matmul_threshold`` at
    ``mlp.wi``'s shape (1024 tokens x 768 x 3072, t = 0.5, unit-RMS
    activations against the fan-in init): values within 1e-5 of the
    largest, the mask equal except where |y| lies within 1e-5 of t; the
    yardstick is ``torch.matmul`` of the bf16 operands followed by the
    threshold."""
    import torch

    from repro_torch.kernels import fused_sparse_matmul as fsm
    from repro_torch.kernels import nm_mask as nmk

    bf16 = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cases = []

    def nm_case(wname, x, n, m, **extra):
        """``nm_mask`` on x bitwise against its plain version, the body it
        took, timed; each element read once, its mask byte written once,
        m compares and adds per element on the CUDA cores."""
        assert torch.equal(nmk.nm_mask(x, n, m), nmk.nm_mask_plain(x, n, m)), \
            f"nm_mask {n}:{m} differs from its plain version on {wname}"
        b, by = bound(x.numel() * (x.element_size() + 1), 2 * m * x.numel(),
                      F32_FLOPS)
        cases.append(dict(
            kernel="nm_mask", model="bert-train", weight=wname,
            K=x.shape[-1], N=x.numel() // x.shape[-1], M=0, n_m=f"{n}:{m}",
            max_abs_err=0.0, tol=0.0, bitwise=True,
            **nm_mask_resources(x, n, m), **extra,
            **timings(lambda: nmk.nm_mask(x, n, m),
                      lambda: nmk.nm_mask_plain(x, n, m), None, flush),
            bound_ms=b, bound_by=by))

    # 2:4 on the stacked leaves (the recomputes) and on one layer of each
    # (the per-layer build: 24 of run (b)'s 30 launches)
    for wname, R, fan_in in (("mlp.wo", 12 * 3072, 3072),
                             ("attn.wo", 12 * 768, 768),
                             ("mlp.wo[layer]", 3072, 3072),
                             ("attn.wo[layer]", 768, 768)):
        x = (torch.randn(R, 768, generator=gen, device="cuda")
             / math.sqrt(fan_in)).to(bf16)

        def topk_scatter(x=x):
            blocks = x.abs().reshape(-1, 4)
            idx = torch.topk(blocks, 2, dim=-1).indices
            return torch.zeros(blocks.shape, dtype=torch.bool,
                               device="cuda").scatter_(-1, idx, True)

        nm_case(wname, x, 2, 4, topk_scatter_ms=time_ms(topk_scatter, flush))

    # 16:32 (the vector body's widest block) and 5:20 (the staged body;
    # 768 = 38 x 20 + 8 leaves a ragged last block): bitwise on the stacked
    # mlp.wo and on small integers full of ties
    wo = (torch.randn(12 * 3072, 768, generator=gen, device="cuda")
          / math.sqrt(3072)).to(bf16)
    ties = torch.randint(-2, 3, (3, 16, 131), generator=gen,
                         device="cuda").to(bf16)
    for n, m in ((16, 32), (5, 20)):
        assert torch.equal(nmk.nm_mask(ties, n, m),
                           nmk.nm_mask_plain(ties, n, m)), \
            f"nm_mask {n}:{m} differs from its plain version on ties"
        nm_case("mlp.wo", wo, n, m)
    # the special values (subnormals rank as 0, NaN kept and never counted,
    # +-0, +-inf, the smallest normal) at one layer's mlp.wo, and the
    # stacked mlp.wo one element into its storage (the staged body)
    nm_case("special", special_values((3072, 768)), 2, 4)
    flat = torch.empty(wo.numel() + 1, dtype=bf16, device="cuda")
    flat[1:] = wo.reshape(-1)
    nm_case("mlp.wo+1", flat[1:].view(wo.shape), 2, 4)
    del wo, ties, flat

    M, K, N = TRAIN_TOKENS, 768, 3072
    a = torch.randn(M, K, generator=gen, device="cuda").to(bf16)
    w = (torch.randn(K, N, generator=gen, device="cuda")
         / math.sqrt(K)).to(bf16)
    val, mask = fsm.matmul_threshold(a, w, THRESHOLD)
    pv, pm = fsm.matmul_threshold_plain(a, w, THRESHOLD)
    y = a.double() @ w.double()
    diff = mask != pm
    near = (y.abs() - THRESHOLD).abs() <= 1e-5 * max(1.0, THRESHOLD)
    assert not bool((diff & ~near).any()), "threshold mask differs"
    err = (val - pv)[~diff].abs().max().item()
    tol = 1e-5 * max(1.0, pv.abs().max().item())
    assert err <= tol, ("matmul_threshold", err, tol)
    again = fsm.matmul_threshold(a, w, THRESHOLD)
    assert torch.equal(val, again[0]) and torch.equal(mask, again[1]), \
        "matmul_threshold launches disagree"

    def library():
        yy = torch.matmul(a, w)
        keep = yy.abs() >= THRESHOLD
        return yy.float() * keep, keep

    b, by = bound(a.numel() * 2 + w.numel() * 2 + M * N * (4 + 1),
                  2 * M * N * K)
    cases.append(dict(
        kernel="matmul_threshold", model="bert-train", weight="mlp.wi",
        K=K, N=N, M=M, threshold=THRESHOLD, max_abs_err=err, tol=tol,
        mask_flips=int(diff.sum()), kept_share=mask.float().mean().item(),
        bitwise_relaunch=True, **matmul_threshold_resources(),
        **timings(lambda: fsm.matmul_threshold(a, w, THRESHOLD),
                  lambda: fsm.matmul_threshold_plain(a, w, THRESHOLD),
                  library, flush),
        bound_ms=b, bound_by=by))
    del flush
    return cases


# ---------------------------------------------------------------------------
# phase 3: the main paths
# ---------------------------------------------------------------------------

KERNELS = ("nmg_gemv", "nmg_qkv", "nmg_spmm", "nmg_ffn")
TRAIN_KERNELS = ("nm_mask", "matmul_threshold")


def reset_counts() -> None:
    from repro_torch.kernels import ops

    ops.reset_kernel_counters()


def read_counts() -> dict:
    """Launches per kernel wrapper, and the routes, from one snapshot of
    both accounts (which count graph replays too)."""
    from repro_torch.kernels import ops

    snap = ops.counter_snapshot()
    counts = dict(snap["launches"])
    counts["routes"] = {f"{k}/{p}": v for (k, p), v in snap["routes"].items()}
    return counts


@contextlib.contextmanager
def plain_versions():
    """Run the model with every kernel wrapper swapped for its plain
    version (on the same CUDA tensors) — the reference side of the
    logit parity check."""
    from repro_torch.kernels.ops import KERNEL_WRAPPERS

    saved = [(mod, attr, getattr(mod, attr))
             for mod, attr, _ in KERNEL_WRAPPERS.values()]
    for mod, attr, plain in KERNEL_WRAPPERS.values():
        setattr(mod, attr, getattr(mod, plain))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def same_cache(a, b) -> bool:
    """Whether two cache trees (flat or a pair layout's) are bitwise
    equal, leaf for leaf."""
    import torch

    from repro_torch.models.transformer import cache_leaves

    la, lb = cache_leaves(a), cache_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def requests_for(cfg):
    """The served trace: 8 requests, prompts cycling (32, 24, 64, 16)
    tokens, 32 new tokens each, greedy."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, PROMPT_LENS[i % 4], dtype=np.int32), max_new_tokens=32)
        for i in range(8)]


PROMPT_LENS = (32, 24, 64, 16)
ENGINE_KW = dict(max_slots=4, max_seq_len=max(PROMPT_LENS) + 32,
                 decode_chunk=8, device="cuda")


def serve_phase(cfg, params, label) -> dict:
    """The trace through the engine twice: replaying its programs as CUDA
    graphs (the default: each prompt length's admission and the decode
    chunk) and with ``graphs=False`` (eager).  Each engine is first warmed
    with the trace's prompt lengths (``warmup_engine``), which builds its
    programs: one ``slot_prefill`` trace event per distinct
    length and one ``decode_chunk``; the measured run, with the counts
    zeroed right before it and read right after, must build none.  The
    token streams must be equal, and so must the counts (a replay counts
    the launches it runs).  Then each prompt length's admission, replayed
    into slot 2, is held bitwise against eager ``prefill_into_slot`` on a
    clone of the cache."""
    import numpy as np
    import torch

    from repro_torch.models import prefill_into_slot
    from repro_torch.models.transformer import map_cache
    from repro_torch.serve import ServeEngine, warmup_engine
    from repro_torch.serve.tracecount import reset_trace_events, \
        trace_events

    runs = {}
    lens = sorted(set(PROMPT_LENS))
    for mode, graphs in (("graph", True), ("eager", False)):
        kw = dict(ENGINE_KW, graphs=graphs)
        reset_trace_events()
        eng = ServeEngine(params, cfg, **kw)
        warmup_engine(eng, requests_for(cfg))
        built = trace_events()
        assert built == {"slot_prefill": len(lens), "decode_chunk": 1}, \
            (label, mode, built)
        torch.cuda.synchronize()
        reset_counts()
        outs = eng.run(requests_for(cfg))
        torch.cuda.synchronize()
        counts = read_counts()
        assert trace_events() == built, (label, mode, trace_events())
        print(f"serve[{label}, {mode}] trace events: {built} after the "
              f"warm-up, {trace_events()} after the served trace")
        assert len(outs) == 8, f"{label}: {len(outs)} of 8 requests finished"
        for o in outs:
            assert o.finish_reason == "length" and len(o.tokens) == 32, (
                label, mode, o.uid, o.finish_reason, len(o.tokens))
            assert all(0 <= t < cfg.vocab for t in o.tokens)
        assert not any(k.endswith("/plain") for k in counts["routes"]), counts
        assert eng._decode_chunk.info["captured"] == graphs
        pg = eng.kv.prefill_graphs
        assert sorted(pg) == lens, (label, sorted(pg))
        for g in pg.values():
            assert g.info["captured"] == graphs
            assert g.info["replays"] == (2 if graphs else 0), g.info
        runs[mode] = {"metrics": eng.metrics(label=label).to_dict(),
                      "counts": counts, "tokens": [o.tokens for o in outs],
                      "decode_steps": eng.stats["decode_steps"],
                      "chunk_graph": dict(eng._decode_chunk.info),
                      "prefill_graphs": {S: dict(g.info)
                                         for S, g in pg.items()},
                      "trace_events": built}
        if graphs:
            rng = np.random.default_rng(3)
            for S in lens:
                prompt = rng.integers(0, cfg.vocab, (1, S), dtype=np.int32)
                ref = map_cache(torch.clone, eng.kv.data)
                got = eng.kv.write_prefill(params, prompt, 2).clone()
                want, _ = prefill_into_slot(
                    params, cfg, torch.as_tensor(prompt, device="cuda"),
                    ref, 2)
                assert torch.equal(got, want), f"{label}: prefill S={S}"
                assert same_cache(eng.kv.data, ref), (label, S)
            del ref
        del eng
    g, e = runs["graph"], runs["eager"]
    assert g["tokens"] == e["tokens"], f"{label}: graph and eager streams differ"
    assert g["counts"] == e["counts"], (label, g["counts"], e["counts"])
    return {"label": label, "metrics": g["metrics"],
            "eager_metrics": e["metrics"], "counts": g["counts"],
            "decode_steps": g["decode_steps"],
            "chunk_graph": g["chunk_graph"],
            "prefill_graphs": g["prefill_graphs"],
            "trace_events": g["trace_events"],
            "first_tokens": [t[:4] for t in g["tokens"]]}


def _bf16_step(x):
    """The spacing of bf16 numbers at the magnitude of ``x``."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.float().abs())) - 7)


def logit_stats(pairs, cap=None, own=None) -> dict:
    """How (got, want) logit pairs [B, V] fare under the 5% rule, and
    whether they pass it (``"ok"``): every difference within 5% of the
    logits' scale (bf16 activations round at ~2**-8 relative per op, and
    rounding flips between two summation orders compound over the
    layers), and the argmax equal unless ``want``'s top two lie within one
    bf16 step of each other (a tie at the logits' own resolution, which
    one flipped rounding breaks).  The scale is the largest ``want``
    logit, or with ``own`` the typical one:

    ``own`` (one [B] tensor of token ids a pair) names each row's own
    column under a tied head (``hidden @ embedding.T``): there the logit
    of the step's input token is about the squared norm of its embedding
    row, an outlier (3120 at full-width gemma2-9b with random weights,
    where the other logits' RMS is about 53, and bf16's spacing at 3120
    is 16).  That
    column is held apart, within two bf16 steps of ``want``; the other
    columns are held within 5% of their RMS in ``want``, and the argmax
    is taken over them.  With ``cap`` (the model's logit softcap; the
    pairs are the logits before it, :func:`uncapped`) the largest
    difference after c·tanh(x/c) in f32 is reported too, unasserted."""
    import torch

    worst, big, agree, ties, sq, n = 0.0, 0.0, 0, 0, 0.0, 0
    own_worst, own_tol, own_ok, argmax_ok = 0.0, 0.0, True, True
    for i, (g, w) in enumerate(pairs):
        g, w = g.float(), w.float()
        big = max(big, w.abs().max().item())
        if own is not None:
            col = own[i].reshape(-1, 1).to(w.device).long()
            d_own = (g.gather(1, col) - w.gather(1, col)).abs()
            step2 = 2 * _bf16_step(w.gather(1, col))
            own_worst = max(own_worst, d_own.max().item())
            own_tol = max(own_tol, step2.max().item())
            own_ok &= bool((d_own <= step2).all())
            keep = torch.ones_like(w, dtype=torch.bool).scatter_(1, col, False)
            sq += w.square().masked_fill(~keep, 0).sum().item()
            n += int(keep.sum())
            g = g.masked_fill(~keep, float("-inf"))
            w = w.masked_fill(~keep, float("-inf"))
            worst = max(worst, (g - w).nan_to_num(0.0).abs().max().item())
        else:
            worst = max(worst, (g - w).abs().max().item())
        top2 = torch.topk(w, 2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= _bf16_step(top2[:, 0])
        same = g.argmax(-1) == w.argmax(-1)
        argmax_ok &= bool((same | tie).all())
        agree += int(same.all())
        ties += int(tie.any())
    scale = (sq / n) ** 0.5 if own is not None else big
    tol = 0.05 * scale
    out = {"ok": argmax_ok and own_ok and worst <= tol, "max_abs_err": worst,
           "tol": tol, "max_abs_logit": big,
           "argmax_agree": f"{agree}/{len(pairs)}", "top2_ties": ties}
    if own is not None:
        out.update(rms_logit=scale, own_col_max_abs_err=own_worst,
                   own_col_tol=own_tol)
    if cap:
        out["capped_max_abs_err"] = max(
            (cap * torch.tanh(g.float() / cap)
             - cap * torch.tanh(w.float() / cap)).abs().max().item()
            for g, w in pairs)
    return out


def hold_logits(pairs, cap=None, own=None) -> dict:
    """:func:`logit_stats`, asserted."""
    out = logit_stats(pairs, cap, own)
    assert out["ok"], f"logits fail the 5% rule: {out}"
    return out


def uncapped(cfg):
    """``cfg`` without its logit softcap, for :func:`hold_logits`: the cap
    c·tanh(x/c) has slope at most 1, so it cannot widen the difference
    between two logits, but it saturates every logit much past c, which
    under gemma2-9b's cap of 30 (against a typical random logit of 60)
    is most of them.  Everything before the head is unchanged."""
    return dataclasses.replace(cfg, logit_softcap=None)


def logit_parity(cfg, params, reference=None, frames: int = 0) -> dict:
    """Prefill (a 32-token prompt: SpMM; a 16-token prompt: GEMV, fused
    QKV and, for a gated MLP, fused FFN) and 4 decode steps, through the
    kernels and through the plain versions (or under ``reference``, a
    context manager, in their place), fed the same tokens, held by
    :func:`hold_logits` (logits before any logit softcap:
    :func:`uncapped`; under a tied head each step's input token names its
    own column).  With ``frames`` (an enc-dec model) each prompt comes
    with seeded frame embeddings of that length, the same for both runs
    (the encoder's projections: the SpMM at N = ``frames``)."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, prefill

    cap, cfg = cfg.logit_softcap, uncapped(cfg)
    rng = np.random.default_rng(1)
    pairs, own = [], []
    for S in (32, 16):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)),
                               device="cuda")
        enc = ({"enc_embeds": encdec_frames(cfg, 2000 + S, frames)}
               if frames else {})

        def steps(feed=None):
            logits, cache = prefill(params, cfg, toks, cache_len=S + 8,
                                    **enc)
            out = [logits.float()]
            fed = []
            tok = torch.argmax(logits, -1)[:, None]
            for i in range(4):
                if feed is not None:
                    tok = feed[i]
                fed.append(tok)
                logits, cache = decode_step(params, cfg, tok, cache,
                                            torch.tensor(S + i, device="cuda"))
                out.append(logits.float())
                tok = torch.argmax(logits, -1)[:, None]
            return out, fed

        with (reference or plain_versions)():
            want, fed = steps()
        got, _ = steps(fed)
        pairs += list(zip(got, want))
        own += [toks[:, -1]] + [t[:, 0] for t in fed]
    return hold_logits(pairs, cap, own if cfg.tie_embeddings else None)


def graph_phase(cfg, params, label, profile: bool = True,
                enc_len: int = 0) -> dict:
    """The engine's decode programs (``serve/graphs.py``) replayed as CUDA
    graphs against the same programs run eagerly, at 4 slots prefilled
    with 32-token prompts (decode chunk 8):

    - bitwise: three chunks with an admission (a 24-token prefill into
      slot 1) after the first, then two single steps, each replayed on the
      live cache and run eagerly on a clone: tokens, logits and caches
      equal, and a replay's launch counts equal the eager run's;
    - capture: host ms of capture and of instantiation, and the bytes the
      capture added to the graph pool (both programs share one pool);
    - where the time goes: the chunk's wall time (median of 5, ending in
      the token block's host fetch) eager and replayed, the replay's
      device span from CUDA events, and the host time to enqueue one
      chunk eagerly and as one replay; each's device time from
      ``torch.profiler`` (the sum of its kernels' device times), busy
      shares and the eager host cost per launch come from
      :func:`finish_graph` once :func:`run_profiles` has run the
      sessions this phase queues (with ``profile`` false none is queued,
      and the replay's device time is its CUDA-event span).

    With ``enc_len`` (an enc-dec model) the cache holds cross K/V of
    that many frames and each admission brings seeded frames.  Every
    cache leaf keeps its storage across the admissions and replays."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, prefill_into_slot
    from repro_torch.models.transformer import cache_leaves, map_cache
    from repro_torch.serve.engine import _decode_chunk_fn, _decode_fn
    from repro_torch.serve.graphs import DecodeGraph

    B, T = 4, 8
    rng = np.random.default_rng(2)

    def prompt(n):
        return torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)),
                               dtype=torch.int32, device="cuda")

    def enc(seed):
        return ({"enc_embeds": encdec_frames(cfg, seed, enc_len)}
                if enc_len else {})

    cache = init_cache(cfg, B, 96, enc_len=enc_len, device="cuda")
    ptrs = [t.data_ptr() for t in cache_leaves(cache)]
    for slot in range(B):
        prefill_into_slot(params, cfg, prompt(32), cache, slot,
                          **enc(3000 + slot))
    ref = map_cache(torch.clone, cache)
    pool = torch.cuda.graph_pool_handle()
    chunk_fn, step_fn = _decode_chunk_fn(cfg, T), _decode_fn(cfg)
    chunk = DecodeGraph(chunk_fn, params, cache, B, pool=pool)
    step = DecodeGraph(step_fn, params, cache, B, pool=pool)
    tok = np.zeros(B, np.int32)
    pos = np.full(B, 32, np.int32)

    def eager(fn, c=ref):
        ops.reset_kernel_counters()
        out = fn(params, torch.as_tensor(tok[:, None], device="cuda"), c,
                 torch.as_tensor(pos, device="cuda"))
        return out, ops.counter_snapshot()

    def held(graph, fn, what):
        ops.reset_kernel_counters()
        got = graph.run(tok, pos).clone()
        replayed = ops.counter_snapshot()
        want, counts = eager(fn)
        assert torch.equal(got, want), f"{label}: replayed {what} differs"
        assert same_cache(cache, ref), f"{label}: {what} cache"
        assert replayed == counts, (label, what, replayed, counts)
        return got, counts

    for turn in range(3):
        got, chunk_counts = held(chunk, chunk_fn, f"chunk {turn}")
        tok, pos = got[-1].cpu().numpy().copy(), pos + T
        if turn == 0:
            p, kw = prompt(24), enc(3010)
            for c in (cache, ref):
                prefill_into_slot(params, cfg, p, c, 1, **kw)
            tok[1], pos[1] = int(got[-1, 1]), 24
    for turn in range(2):
        got, _ = held(step, step_fn, f"step {turn}")
        tok, pos = got.argmax(-1).int().cpu().numpy(), pos + 1
    assert chunk.info["replays"] == 2 and step.info["replays"] == 1
    assert [t.data_ptr() for t in cache_leaves(cache)] == ptrs, label

    # timing at fixed inputs (each run rewrites the same cache rows)
    tok, pos = np.zeros(B, np.int32), np.full(B, 40, np.int32)
    tok_d = torch.as_tensor(tok[:, None], device="cuda")
    pos_d = torch.as_tensor(pos, device="cuda")

    def eager_chunk():
        t0 = time.perf_counter()
        chunk_fn(params, tok_d, ref, pos_d).cpu()
        return time.perf_counter() - t0

    def replay_chunk():
        t0 = time.perf_counter()
        chunk.run(tok, pos).cpu()
        return time.perf_counter() - t0

    eager_chunk()
    replay_chunk()
    eager_wall = statistics.median(eager_chunk() for _ in range(5))
    replay_wall = statistics.median(replay_chunk() for _ in range(5))
    # CUDA events around replays: the device span of one chunk, gaps
    # between its kernels included
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    for s_, e_ in zip(starts, ends):
        torch.cuda.synchronize()
        s_.record()
        chunk.graph.replay()
        e_.record()
    torch.cuda.synchronize()
    replay_span_ms = statistics.median(
        s_.elapsed_time(e_) for s_, e_ in zip(starts, ends))
    # host time to enqueue one chunk, no sync: eagerly (the device keeps
    # up, so no launch waits for a full queue) and as one replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk_fn(params, tok_d, ref, pos_d)
    eager_enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk.graph.replay()
    replay_enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return {
        "label": label, "slots": B, "chunk": T,
        "bitwise": "3 chunks (admission after the first), 2 steps",
        "wrapper_launches_per_chunk": chunk_counts["launches"],
        "chunk_graph": dict(chunk.info), "step_graph": dict(step.info),
        "eager_wall_ms": eager_wall * 1e3,
        "replay_wall_ms": replay_wall * 1e3,
        "replay_event_span_ms": replay_span_ms,
        "eager_enqueue_ms": eager_enqueue_ms,
        "replay_enqueue_ms": replay_enqueue_ms,
        "eager_profile": profile_later(eager_chunk, eager_wall)
        if profile else {},
        "replay_profile": profile_later(replay_chunk, replay_wall)
        if profile else {}}


PREFILL_LENS = (16, 24, 32, 64)
TIMED_PREFILLS = 7


def prefill_phase(cfg, params, label, profile: bool = True) -> dict:
    """The engine's admission programs (``serve/graphs.py:PrefillGraph``,
    one per prompt length S in ``PREFILL_LENS``, sharing one graph pool)
    at 4 slots of 96 rows, each against the same program run eagerly (a
    ``PrefillGraph`` with capture off: the ``graphs=False`` admission):

    - bitwise: the first run (eager on the capture stream, then captured)
      into slot 1 and a replay into slot 3 at offset 8, each against eager
      ``prefill_into_slot`` on a clone of the cache: logits and caches
      equal, and the launch and route counts of each run equal the eager
      run's;
    - capture: host ms of capture and of instantiation, and the bytes the
      capture added to the pool;
    - wall time of one admission (median of ``TIMED_PREFILLS``, each
      ending in the logits' host fetch), replayed and eager, unprofiled,
      and the replay's device span from CUDA events; each's device time
      from ``torch.profiler`` is queued for :func:`run_profiles` (with
      ``profile`` false none is queued)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, prefill_into_slot
    from repro_torch.models.transformer import map_cache
    from repro_torch.serve.cache import _slot_prefill_fn
    from repro_torch.serve.graphs import PrefillGraph

    cache = init_cache(cfg, 4, 96, device="cuda")
    pool = torch.cuda.graph_pool_handle()
    fn = _slot_prefill_fn(cfg)
    rng = np.random.default_rng(4)
    rows = []
    for S in PREFILL_LENS:
        g = PrefillGraph(fn, params, cache, S, pool=pool)
        plain = PrefillGraph(fn, params, cache, S, capture=False)
        for turn, (slot, off) in enumerate(((1, 0), (3, 8))):
            prompt = rng.integers(0, cfg.vocab, (1, S), dtype=np.int32)
            ref = map_cache(torch.clone, cache)
            ops.reset_kernel_counters()
            got = g.run(prompt, slot, off).clone()
            replayed = ops.counter_snapshot()
            ops.reset_kernel_counters()
            want, _ = prefill_into_slot(
                params, cfg, torch.as_tensor(prompt, device="cuda"), ref,
                slot, write_offset=off)
            counts = ops.counter_snapshot()
            assert torch.equal(got, want), f"{label} S={S}: logits {turn}"
            assert same_cache(cache, ref), (label, S, turn)
            assert replayed == counts, (label, S, turn, replayed, counts)
        del ref
        assert g.info["captured"] and g.info["replays"] == 1
        prompt = rng.integers(0, cfg.vocab, (1, S), dtype=np.int32)

        def timed(prog, prompt=prompt):
            def one():
                t0 = time.perf_counter()
                prog.run(prompt, 1, 0).cpu()
                return time.perf_counter() - t0
            return one

        eager_one, replay_one = timed(plain), timed(g)
        eager_one()
        replay_one()
        eager_wall = statistics.median(
            eager_one() for _ in range(TIMED_PREFILLS))
        replay_wall = statistics.median(
            replay_one() for _ in range(TIMED_PREFILLS))
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        for s_, e_ in zip(starts, ends):
            torch.cuda.synchronize()
            s_.record()
            g.graph.replay()
            e_.record()
        torch.cuda.synchronize()
        rows.append({
            "S": S, "launches": counts["launches"],
            "graph": dict(g.info), "eager_wall_ms": eager_wall * 1e3,
            "replay_wall_ms": replay_wall * 1e3,
            "replay_event_span_ms": statistics.median(
                s_.elapsed_time(e_) for s_, e_ in zip(starts, ends)),
            "eager_profile": profile_later(eager_one, eager_wall)
            if profile else {},
            "replay_profile": profile_later(replay_one, replay_wall)
            if profile else {}})
    return {"label": label, "slots": 4, "cache_rows": 96,
            "bitwise": "first run (captured) into slot 1, a replay into "
                       "slot 3 at offset 8", "lens": rows}


def report_prefill(phases, card) -> None:
    for p in phases:
        for r in p["lens"]:
            e, rp, gi = r["eager_profile"], r["replay_profile"], r["graph"]

            def busy(prof, wall_ms):
                ms = prof.get("device_busy_ms")
                return ("not measured" if not ms else
                        f"busy {ms:.3f} ms ({ms / wall_ms * 100:.1f}%)")

            r["eager_busy_ms"] = e.get("device_busy_ms")
            r["replay_busy_ms"] = rp.get("device_busy_ms")
            print(f"prefill[{p['label']}] S={r['S']} on {card}: replay "
                  f"bitwise eager; replayed {r['replay_wall_ms']:.3f} ms "
                  f"wall, {busy(rp, r['replay_wall_ms'])}, event span "
                  f"{r['replay_event_span_ms']:.3f} ms; eager "
                  f"{r['eager_wall_ms']:.3f} ms wall, "
                  f"{busy(e, r['eager_wall_ms'])}, {e.get('launches')} "
                  f"launches; capture {gi['capture_ms']:.1f} ms + "
                  f"instantiate {gi['instantiate_ms']:.1f} ms, pool "
                  f"+{gi['pool_bytes'] / 2**20:.1f} MiB; kernels "
                  + " ".join(f"{k[4:]} {r['launches'][k]}" for k in KERNELS))


def finish_graph(p: dict) -> dict:
    """The numbers of a :func:`graph_phase` that read its profiles (after
    :func:`run_profiles`): busy times and shares, launches, host cost per
    launch."""
    e, r = p["eager_profile"], p["replay_profile"]
    busy, busy_from = r["device_busy_ms"], "profiler"
    if not busy:
        busy, busy_from = p["replay_event_span_ms"], "cuda events"
    p.update(
        eager_busy_ms=e["device_busy_ms"],
        eager_busy_share=e["device_busy_share"],
        replay_busy_ms=busy, replay_busy_from=busy_from,
        replay_busy_share=busy / p["replay_wall_ms"],
        replay_over_busy=p["replay_wall_ms"] / busy,
        launches_per_step=e["launches"] / p["chunk"],
        eager_host_us_per_launch=p["eager_enqueue_ms"] * 1e3 / e["launches"],
        eager_top_kernels=e["top_kernels"],
        replay_top_kernels=r["top_kernels"])
    return p


#: profiler sessions, run after every unprofiled timing of the script: one
#: torch.profiler session leaves every later launch in the process slower
#: (the host's enqueue of bert's replayed chunk 0.182 -> 4.323 ms, its
#: wall 14.518 -> 18.744 ms on an H100 80GB HBM3 at 700 W, measured by
#: scripts/graph_gaps.py)
_PROFILES: list = []


def profile_later(fn, wall_s: float, into: dict = None) -> dict:
    """``into`` (a new dict by default), which :func:`run_profiles` fills
    with :func:`device_profile` of ``fn``."""
    into = {} if into is None else into
    _PROFILES.append((fn, wall_s, into))
    return into


def run_profiles() -> None:
    while _PROFILES:
        fn, wall_s, into = _PROFILES.pop(0)
        into.update(device_profile(fn, wall_s))


def device_profile(fn, wall_s: float) -> dict:
    """One call of ``fn`` under torch.profiler: the kernels' device time
    (the sum of their durations), launches, the top kernels, and the busy
    share against ``wall_s``, the unprofiled wall time of one call.

    The session records device activity alone and sums the profiler's
    raw events: for qwen1.5-4b's eager decode chunk (26,714 device
    events, H100 80GB HBM3 at 700 W) a session that also recorded every
    host op took 10.4 s and its ``key_averages()`` 17.6 s more, against
    1.8 s for a device-only session; :func:`run_profiles` took 161 s of a
    1162 s smoke that way."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_prof = fn()
    kern: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, ns = kern.get(e.name(), (0, 0))
            kern[e.name()] = (n + 1, ns + e.duration_ns())
    busy_us = sum(ns for _, ns in kern.values()) / 1e3
    top = sorted(kern.items(), key=lambda kv: kv[1][1], reverse=True)[:8]
    return {"wall_profiled_ms": wall_prof * 1e3,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "device_busy_share": busy_us / 1e6 / wall_s if busy_us else None,
            "launches": sum(n for n, _ in kern.values()),
            "top_kernels": [{"name": name[:80], "count": n,
                             "device_us": ns / 1e3}
                            for name, (n, ns) in top]}


# ---------------------------------------------------------------------------
# phases 3d and 3e: starcoder2-15b and gemma2-9b, then paligemma-3b and
# minicpm3-4b, at full width and depth, each pair in a process of its own
# ---------------------------------------------------------------------------

#: the model families served in a process of their own: flag ->
#: ((architecture, at SMOKE, n:m:g group rows) each, the JSON file the
#: child writes under chiprun_out/)
FAMILY_RUNS = {
    "--families": ((("starcoder2-15b", False, 64), ("gemma2-9b", False, 64)),
                   "chip_smoke_families.json"),
    "--vlm-mla": ((("paligemma-3b", False, 64), ("minicpm3-4b", False, 64)),
                  "chip_smoke_vlm_mla.json"),
    # arctic's full width needs more than one card: its SMOKE config, in
    # the CPU tests' gr16 format
    "--moe": ((("moonshot-v1-16b-a3b", False, 64), ("arctic-480b", True, 16)),
              "chip_smoke_moe.json"),
    "--ssm": ((("mamba2-370m", False, 64), ("hymba-1.5b", False, 64)),
              "chip_smoke_ssm.json"),
    "--encdec": ((("whisper-large-v3", False, 64),),
                 "chip_smoke_encdec.json"),
    # phases 3k, 3l and 3m run their own sequences (kvcache_phase,
    # slo_phase, check_phase)
    "--kvcache": ((), "chip_smoke_kvcache.json"),
    "--slo": ((), "chip_smoke_slo.json"),
    "--check": ((), "chip_smoke_check.json"),
    "--dist": ((), "chip_smoke_dist.json"),
}
#: the depth (decoder layers; whisper's encoder and decoder) at which the
#: earlier family phases serve their full-width models, so that the whole
#: smoke, phase (l) included, stays inside its time limit.  Every check of
#: each phase still runs; the kernels' main-path launches come from phase
#: (b)'s qwen1.5-4b at its full 40 layers, and (l) serves qwen at 40.
#: moonshot runs 24 of its 48 layers too: with it whole the smoke read
#: 1080 s on the H100 (PERF.md), over the 960 s it is to stay under.
#: mamba2 runs 16 of its 48 layers and whisper 12 + 12 of 32 + 32 (24
#: and 16 + 16 before): with phase (o) added the smoke read 1324 s on
#: the H100's host, over its 1200 s limit (PERF.md).  The smoke then read
#: 915 s on one host and 1162 s on another, and outlasted 1200 s on a
#: third: each of these seven now runs half the depth it ran there
#: (starcoder2 and gemma2 20, minicpm3 16, moonshot 24, mamba2 and hymba
#: 16, whisper 12 + 12), so that the smoke ends in about half its limit.
#: Models not named here run at their published depth.
#: Phase (m) checks qwen1.5-4b's serve programs at 4 layers: the rules
#: judge every layer's program alike, and R6 depends on widths alone.
#: Phase (n) runs qwen1.5-4b's sharded prefill and decode at 4 layers and
#: moonshot's expert-parallel forward at 2: DTensor dispatches every op
#: eagerly on the host, the same for every layer, and the phase is to
#: stay within 45 s.  Phase (o2) holds qwen1.5-4b's decode step at 4
#: layers against its count (every layer's program is alike).
PHASE_DEPTH = {"starcoder2-15b": 10, "gemma2-9b": 10, "minicpm3-4b": 8,
               "moonshot-v1-16b-a3b": 12, "mamba2-370m": 8,
               "hymba-1.5b": 8, "whisper-large-v3": (6, 6),
               "check/qwen1.5-4b": 4, "dist/qwen1.5-4b": 4,
               "dist/moonshot-v1-16b-a3b": 2, "dryrun/qwen1.5-4b": 4}
WINDOW_PROMPT, WINDOW_SEQ, WINDOW_NEW = 4160, 4224, 32
#: paligemma's image request: its 256 patch rows, a 32-token prompt, 32
#: new tokens; minicpm3's long request: 1024 + 32 tokens
PREFIX_PROMPT, LATENT_PROMPT, LONG_NEW = 32, 1024, 32
#: an attention sublayer's output at the last position is held to the
#: full forward's within this RMS of their difference over its RMS
ATTN_TOL = 0.1


def step_weight_bytes(params) -> int:
    """Bytes of weights one decode step reads: every layer leaf (an n:m:g
    leaf's values and gather plan, a dense leaf whole) but an enc-dec
    decoder's ``xattn.wk`` / ``wv`` (they make the cross K/V at admission;
    decode reads the cache), the final norm and the head (a tied
    embedding whole; an untied model's embedding is read only at the
    batch's rows and left out); an encoder's layers are not read at
    decode.  A size from the params, not a measurement."""
    from repro_torch.core.layouts import GroupedNMTensor

    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        if isinstance(t, GroupedNMTensor):
            return storage_bytes(t)
        return t.numel() * t.element_size()

    layers = params["layers"]
    if "xattn" in layers:
        layers = {**layers, "xattn": {k: v for k, v in layers["xattn"]
                                      .items() if k not in ("wk", "wv")}}
    return (nbytes(layers) + nbytes(params["final_norm"])
            + nbytes(params.get("lm_head", params["embedding"])))


def _gb_peak() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def window_phase(cfg, params) -> dict:
    """One gemma2 request across the window: a 4160-token prompt (4160 %
    4096 != 0, so the local rings wrap at admission) and 32 new tokens,
    through the graphs of a one-slot engine of 4224 rows (local rings of
    4096 rows, global caches of 4224), warmed with the request itself
    (its admission's capture), then served replayed.  The same tokens fed
    through eager ``prefill_into_slot`` and ``decode_step`` on a fresh
    cache give the same stream, and the last step's logits (before the
    softcap, :func:`uncapped`) are held by :func:`hold_logits` against
    the port's own full ``forward`` over the prompt and the fed tokens
    (the slot rule's invariant) and against the same steps through the
    plain versions.  The cache those steps leave is held row by row
    (:func:`cache_rows`) to the classic ``prefill`` of the fed tokens.
    At a window of 4096 rows a misplaced ring row moves the logits little
    (random weights attend to every row alike), so the rows are the check
    of the ring; controls, each of which must fail its check
    (:func:`check_window`): the ring laid out as the reference's classic
    prefill lays it (ROADMAP C10) fails the rows, and the model without
    its post-norms or with silu in place of gelu fails the logits."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, forward, init_cache, \
        logits_of, prefill, prefill_into_slot
    from repro_torch.serve import Request, ServeEngine, warmup_engine

    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab, WINDOW_PROMPT, dtype=np.int32)

    def trace():
        return [Request(uid=0, prompt=prompt, max_new_tokens=WINDOW_NEW)]

    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(params, cfg, max_slots=1, max_seq_len=WINDOW_SEQ,
                      decode_chunk=8, device="cuda")
    assert eng.kv.data["local"]["k"].shape[2] == cfg.local_window
    assert eng.kv.data["global"]["k"].shape[2] == WINDOW_SEQ
    t0 = time.perf_counter()
    warmup_engine(eng, trace())
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_counts()
    (out,) = eng.run(trace())
    torch.cuda.synchronize()
    counts = read_counts()
    tokens = out.tokens
    assert len(tokens) == WINDOW_NEW and out.finish_reason == "length"
    g = eng.kv.prefill_graphs[WINDOW_PROMPT]
    assert g.info["captured"] and g.info["replays"] == 1, g.info
    assert eng._decode_chunk.info["captured"]
    for k in ("nmg_gemv", "nmg_qkv", "nmg_spmm", "nmg_ffn"):
        assert counts[k] > 0, f"{k} never launched on the window request"
    res = {"prompt": WINDOW_PROMPT, "new_tokens": WINDOW_NEW,
           "cache_rows": {"local": cfg.local_window, "global": WINDOW_SEQ},
           "metrics": eng.metrics(label="gemma2_window").to_dict(),
           "warmup_s": warm_s, "admission_graph": dict(g.info),
           "chunk_graph": dict(eng._decode_chunk.info),
           "serve_peak_gb": _gb_peak(), "counts": counts}
    del eng, g
    torch.cuda.empty_cache()

    def steps(c, fault=None):
        cache = init_cache(c, 1, WINDOW_SEQ, device="cuda")
        logits, _ = prefill_into_slot(
            params, c, torch.as_tensor(prompt[None], device="cuda"),
            cache, 0)
        if fault is not None:
            fault(cache)
        stream = [int(logits.argmax(-1))]
        for i in range(WINDOW_NEW - 1):
            logits, _ = decode_step(
                params, c, torch.tensor([[tokens[i]]], device="cuda"),
                cache, torch.tensor([WINDOW_PROMPT + i], device="cuda"))
            stream.append(int(logits.argmax(-1)))
        return logits.float(), stream, cache

    def classic_ring(cache):
        # the reference's classic prefill (ROADMAP C10): the prompt's last
        # S_c positions at rows 0.. in order, the ring's tail at row 0
        for leaf in cache["local"].values():
            leaf.copy_(torch.roll(leaf, -(WINDOW_PROMPT % leaf.shape[2]), 2))

    _, stream, _ = steps(cfg)
    assert stream == tokens, "eager steps and the replayed engine differ"
    # the logits are held before the softcap (:func:`uncapped`), the last
    # step's input token naming the tied head's own column
    cap, raw = cfg.logit_softcap, uncapped(cfg)
    own = [torch.tensor([tokens[-2]])]
    got, _, cache = steps(raw)
    with plain_versions():
        plain, _, _ = steps(raw)
    fed = torch.as_tensor(np.concatenate(
        [prompt, np.asarray(tokens[:-1], np.int32)])[None], device="cuda")
    hidden = forward(params, raw, fed)
    full = logits_of(params, raw, hidden[:, -1:])[:, 0].float()
    del hidden
    res["vs_full_forward"] = hold_logits([(got, full)], cap, own)
    res["vs_plain"] = hold_logits([(got, plain)], cap, own)
    _, ref = prefill(params, raw, fed, cache_len=WINDOW_SEQ)
    res["rows_vs_prefill"] = cache_rows(cache, ref)
    del cache
    # faults each check must see, computed in bf16 through the kernels
    logits, _, bad = steps(raw, classic_ring)
    res["controls"] = {"classic_ring": {
        "rows": cache_rows(bad, ref),
        "logits": logit_stats([(logits, full)], cap, own)}}
    del bad, ref
    for name, c in (("no_post_norms", dataclasses.replace(raw, post_norms=False)),
                    ("silu_for_gelu", dataclasses.replace(raw, act="silu"))):
        res["controls"][name] = {
            "logits": logit_stats([(steps(c)[0], full)], cap, own)}
    check_window(res)
    return res


#: a cache row is held to its counterpart within this RMS of their
#: difference over the counterpart's RMS; the rows of two different
#: positions differ by about sqrt(2)
ROW_TOL = 0.25


def cache_rows(cache, ref) -> dict:
    """Every row of every leaf of a pair cache against ``ref``'s: the
    largest relative RMS difference of a row and the rows over
    :data:`ROW_TOL`, local rings and global leaves apart."""
    out = {}
    for group in ("local", "global"):
        worst, over = 0.0, 0
        for name in ("k", "v"):
            a = cache[group][name].float()
            b = ref[group][name].float()
            rel = ((a - b).square().mean((-2, -1)).sqrt()
                   / b.square().mean((-2, -1)).sqrt().clamp_min(1e-30))
            worst = max(worst, rel.max().item())
            over += int((rel > ROW_TOL).sum())
        out[group] = {"max_rel_rms_err": worst, "rows_over": over}
    return out


def check_window(res) -> None:
    """:func:`window_phase`'s cache rows held to the classic prefill over
    the fed tokens, and its controls failing the checks."""
    rows, ctl = res["rows_vs_prefill"], res["controls"]
    assert rows["local"]["rows_over"] == rows["global"]["rows_over"] == 0, rows
    assert ctl["classic_ring"]["rows"]["local"]["rows_over"] > 0, ctl
    for name in ("no_post_norms", "silu_for_gelu"):
        assert not ctl[name]["logits"]["ok"], (name, ctl[name])


@contextlib.contextmanager
def attn_rows(into: list, last: bool = True):
    """While inside, append to ``into`` every attention sublayer's output
    at the last position (before any post-norm), [B, D] in f32, in call
    order: a forward's (``apply_gqa`` / ``apply_mla``) last row, a decode
    step's (``_decode_gqa_at`` / ``decode_mla``) row, one per layer; an
    SSM mixer's (``apply_ssm`` / ``decode_ssm``) likewise, after its
    layer's attention in a hybrid layer; with ``last`` false every
    position's, [B, S, D].  Python runs these only
    in eager programs: a graph replay records nothing."""
    from repro_torch.models import attention, ssm, transformer

    hooks = ((attention, "apply_gqa", 0), (attention, "apply_mla", 0),
             (attention, "decode_mla", None),
             (transformer, "_decode_gqa_at", None),
             (ssm, "apply_ssm", 0), (ssm, "decode_ssm", 0))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in hooks]

    def recorder(fn, part):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            a = out if part is None else out[part]
            into.append((a[:, -1] if last else a).float())
            return out
        return rec

    for (mod, name, fn), (_, _, part) in zip(saved, hooks):
        setattr(mod, name, recorder(fn, part))
    try:
        yield into
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def attn_gap(got: list, want: list) -> dict:
    """Each layer's attention output at the last position (:func:`attn_rows`)
    against ``want``'s: the RMS of the difference over ``want``'s RMS, its
    worst and the layers over :data:`ATTN_TOL`.  With random weights a
    token's logits are mostly its own embedding's (scaled by
    sqrt(d_model)), so the context reaches them little; this is where a
    fault in the attention shows."""
    assert len(got) == len(want) > 0, (len(got), len(want))
    rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for a, b in zip(got, want)]
    return {"max_rel_rms_err": max(rel), "tol": ATTN_TOL,
            "layers_over": sum(r > ATTN_TOL for r in rel),
            "per_layer": [round(r, 5) for r in rel]}


def check_ok(c: dict) -> bool:
    """A long request's check: its logits under the rule and every layer's
    attention output within :data:`ATTN_TOL`."""
    return c["logits"]["ok"] and c["attn"]["layers_over"] == 0


def long_request(cfg, params, label, prompt_len, prefix=None,
                 fault=None) -> dict:
    """One request of ``prompt_len`` tokens (behind ``prefix`` [1, P, D]
    patch embeddings, if given) and :data:`LONG_NEW` new tokens in a
    one-slot engine of P + prompt + new rows.  Without a prefix it is
    served by the engine, warmed with the request itself (its
    admission's capture), then replayed.  With one it is admitted by
    ``prefill_into_slot(prefix_embeds=)`` into the engine's cache (the
    engine's programs take no prefix, as the reference's take none), and
    decoded by the engine's decode programs: three 8-step chunks, then
    single steps, each captured at its first run and replayed after, the
    last step's logits kept.  The same tokens fed through eager
    ``prefill_into_slot`` and ``decode_step`` on a fresh cache give the
    same stream (and the replayed last logits bitwise); that last step is
    then held against one full ``forward`` over everything fed (the slot
    rule's invariant): its logits by :func:`hold_logits` and each layer's
    attention output by :func:`attn_gap`, and against the same steps
    through the plain versions.  ``fault`` (a control) edits the eager
    run's cache before its last step, or, with ``"causal"``, the full
    forward is replaced by one over the same embeddings with no prefix
    mask; either must fail the check (:func:`check_ok`)."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, forward, init_cache, \
        logits_of, prefill_into_slot
    from repro_torch.models.transformer import _embed
    from repro_torch.serve import Request, ServeEngine, warmup_engine

    P = 0 if prefix is None else prefix.shape[1]
    rows, new = P + prompt_len + LONG_NEW, LONG_NEW
    prompt = np.random.default_rng(6).integers(0, cfg.vocab, prompt_len,
                                               dtype=np.int32)
    prompt_d = torch.as_tensor(prompt[None], device="cuda")
    res = {"label": label, "prefix_rows": P, "prompt": prompt_len,
           "new_tokens": new, "cache_rows": rows}
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(params, cfg, max_slots=1, max_seq_len=rows,
                      decode_chunk=8, device="cuda")
    replayed = None
    if prefix is None:
        def trace():
            return [Request(uid=0, prompt=prompt, max_new_tokens=new)]

        t0 = time.perf_counter()
        warmup_engine(eng, trace())
        res["warmup_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        reset_counts()
        (out,) = eng.run(trace())
        torch.cuda.synchronize()
        res["counts"] = read_counts()
        tokens = out.tokens
        assert len(tokens) == new and out.finish_reason == "length"
        g = eng.kv.prefill_graphs[prompt_len]
        assert g.info["captured"] and g.info["replays"] == 1, g.info
        res.update(metrics=eng.metrics(label=label).to_dict(),
                   admission_graph=dict(g.info))
    else:
        chunks = (new - 2) // 8
        singles = new - 1 - 8 * chunks
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits, _ = prefill_into_slot(params, cfg, prompt_d, eng.kv.data, 0,
                                      prefix_embeds=prefix)
        tokens = [int(logits.argmax(-1))]
        t1 = time.perf_counter()
        pos = P + prompt_len
        for _ in range(chunks):
            blk = eng._decode_chunk.run([tokens[-1]], [pos]).cpu()
            tokens += [int(t) for t in blk[:, 0]]
            pos += 8
        for _ in range(singles):
            last = eng._decode.run([tokens[-1]], [pos])
            tokens.append(int(last[0].argmax()))
            pos += 1
        replayed = last.float().clone()
        torch.cuda.synchronize()
        res.update(admission_ms=(t1 - t0) * 1e3,
                   decode_s=time.perf_counter() - t1, counts=read_counts(),
                   chunk_graph=dict(eng._decode_chunk.info),
                   step_graph=dict(eng._decode.info))
        assert eng._decode_chunk.info["replays"] == chunks - 1
        assert eng._decode.info["replays"] == singles - 1
        assert len(tokens) == new
    res["serve_peak_gb"] = _gb_peak()
    del eng
    torch.cuda.empty_cache()

    def steps(record=None, edit=None):
        """The request fed eagerly on a fresh cache: the last step's
        logits, and the stream; ``record`` gets the last step's attention
        rows, ``edit`` the cache before that step."""
        cache = init_cache(cfg, 1, rows, device="cuda")
        logits, _ = prefill_into_slot(params, cfg, prompt_d, cache, 0,
                                      prefix_embeds=prefix)
        stream = [int(logits.argmax(-1))]
        for i in range(new - 1):
            last = i == new - 2
            if last and edit is not None:
                edit(cache)
            with attn_rows(record) if last and record is not None \
                    else contextlib.nullcontext():
                logits, _ = decode_step(
                    params, cfg, torch.tensor([[tokens[i]]], device="cuda"),
                    cache, torch.tensor([P + prompt_len + i], device="cuda"))
            stream.append(int(logits.argmax(-1)))
        return logits.float(), stream

    got_rows, full_rows = [], []
    got, stream = steps(got_rows)
    assert stream == tokens, f"{label}: eager steps and the engine differ"
    if replayed is not None:
        assert torch.equal(got, replayed), f"{label}: replay differs"
    fed = torch.as_tensor(np.concatenate(
        [prompt, np.asarray(tokens[:-1], np.int32)])[None], device="cuda")
    with attn_rows(full_rows):
        hidden = forward(params, cfg, fed, prefix_embeds=prefix)
    full = logits_of(params, cfg, hidden[:, -1:])[:, 0].float()
    del hidden
    cap = cfg.logit_softcap
    own = [torch.tensor([tokens[-2]])] if cfg.tie_embeddings else None
    with plain_versions():
        plain, _ = steps()
    res["vs_full_forward"] = {"logits": hold_logits([(got, full)], cap, own),
                              "attn": attn_gap(got_rows, full_rows)}
    assert check_ok(res["vs_full_forward"]), (label, res["vs_full_forward"])
    res["vs_plain"] = hold_logits([(got, plain)], cap, own)
    bad_rows = []
    if fault == "causal":
        # the control: the same embeddings, the text scaled as ``_embed``
        # scales it, with no prefix mask (causal over the image too)
        emb = torch.cat([prefix.to(cfg.tdtype), _embed(params, cfg, fed)], 1)
        with attn_rows(bad_rows):
            hidden = forward(params, cfg, embeds=emb)
        bad = logits_of(params, cfg, hidden[:, -1:])[:, 0].float()
        del hidden, emb
    else:
        bad, _ = steps(bad_rows, fault)
    res["control"] = {"logits": logit_stats([(bad, full)], cap, own),
                      "attn": attn_gap(bad_rows, full_rows)}
    assert not check_ok(res["control"]), (label, res["control"])
    return res


def prefix_phase(cfg, params) -> dict:
    """paligemma's image request (:func:`long_request`): ``vision_prefix``
    seeded patch embeddings, bf16 N(0, 1) (a projector's output scale;
    the text rows, scaled by sqrt(d_model), are ~45x larger), a 32-token
    prompt and 32 new tokens.  Control: the same embeddings fed causally
    (no prefix mask)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(24)
    prefix = torch.randn(1, cfg.vision_prefix, cfg.d_model, generator=gen,
                         device="cuda").to(torch.bfloat16)
    return long_request(cfg, params, "paligemma_prefix", PREFIX_PROMPT,
                        prefix=prefix, fault="causal")


def latent_phase(cfg, params) -> dict:
    """minicpm3's long request (:func:`long_request`): 1024 + 32 tokens
    through the engine, the absorbed decode over the compressed cache
    held to the un-absorbed full forward (exact up to rounding).
    Control: the ``kr`` rows of the cache zeroed before the last step
    (the decoupled RoPE term dropped from every cached key)."""
    def drop_rope(cache):
        cache["kr"].zero_()

    return long_request(cfg, params, "minicpm3_latent", LATENT_PROMPT,
                        fault=drop_rope)


# ---------------------------------------------------------------------------
# phase 3i: mamba2-370m and hymba-1.5b (the SSM mixer, recurrent state)
# ---------------------------------------------------------------------------

#: each SSM model's long request: prompt tokens and the engine's cache
#: rows (LONG_NEW new tokens).  mamba2's prompt spans 16 chunks of the
#: 256-step scan; hymba's 17, and with 4224 rows against its window of
#: 2048 its local layers write at the position and attend over the window
#: (the non-ring path)
SSM_LONG = {"mamba2-370m": (4096, 4096 + LONG_NEW),
            "hymba-1.5b": (4160, 4224)}


def ssm_sparsify(params, gr: int):
    """mamba2's n:m:g copy: 1:4:8 with ``gr`` group rows on the mixer's
    ``in_proj`` and ``out_proj`` through a ``SparsityBuilder`` plan (the
    serving globs, ``*mlp.*`` / ``*attn.*``, match no leaf of an
    attention-free model)."""
    from repro_torch.core.builder import SparsityBuilder
    from repro_torch.core.layouts import GroupedNMTensor
    from repro_torch.core.sparsifiers import GroupedNMSparsifier

    sb = SparsityBuilder()
    sp = GroupedNMSparsifier(1, 4, 8, gr, sparse_dim=0)
    sb.set_weight("*ssm.in_proj", sp, GroupedNMTensor)
    sb.set_weight("*ssm.out_proj", sp, GroupedNMTensor)
    return sb.sparsify_params(params)


def ssm_state_bytes(cfg, slots: int) -> int:
    """Bytes of the recurrent state of ``slots`` slots (every layer's
    ``conv`` and ``ssm`` leaves; 0 without an SSM): a decode step reads
    it and writes it once.  A size from the config, not a measurement."""
    from repro_torch.models import init_cache
    from repro_torch.models.transformer import cache_leaves

    if cfg.ssm is None:
        return 0
    st = init_cache(cfg, slots, 2, device="meta")["ssm_state"]
    return sum(t.numel() * t.element_size() for t in cache_leaves(st))


def ssm_long_request(cfg, params, label) -> dict:
    """The model's long request (:data:`SSM_LONG`) in a one-slot engine,
    warmed with the request itself (its admission's capture), then served
    replayed.  Checks, each against bounds fixed here:

    - the slot's ``conv`` / ``ssm`` state right after an admission (a
      replay of the captured program) bitwise an eager classic
      ``prefill``'s;
    - the same tokens fed through eager ``prefill_into_slot`` and
      ``decode_step`` on a fresh cache give the engine's stream; every
      step's logits (the admission's and each decode step's) held by
      :func:`hold_logits` against one teacher-forced ``forward`` over the
      prompt and the fed tokens, and against the same steps through the
      plain versions;
    - the last step's mixer outputs (:func:`attn_rows`: attention and SSM
      apart in a hybrid layer) each within :data:`ATTN_TOL` of the full
      forward's (:func:`attn_gap`).

    Controls, each of which must fail the per-layer check: the last step
    decoded from a zeroed ``ssm`` state, and for hymba the last step's
    attention without its window."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, forward, init_cache, \
        logits_of, prefill, prefill_into_slot
    from repro_torch.serve import Request, ServeEngine, warmup_engine

    prompt_len, rows = SSM_LONG[cfg.name]
    new = LONG_NEW
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, prompt_len,
                                               dtype=np.int32)
    prompt_d = torch.as_tensor(prompt[None], device="cuda")
    res = {"label": label, "prompt": prompt_len, "new_tokens": new,
           "cache_rows": rows}

    def trace():
        return [Request(uid=0, prompt=prompt, max_new_tokens=new)]

    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(params, cfg, max_slots=1, max_seq_len=rows,
                      decode_chunk=8, device="cuda")
    t0 = time.perf_counter()
    warmup_engine(eng, trace())
    res["warmup_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_counts()
    (out,) = eng.run(trace())
    torch.cuda.synchronize()
    res["counts"] = read_counts()
    tokens = out.tokens
    assert len(tokens) == new and out.finish_reason == "length"
    g = eng.kv.prefill_graphs[prompt_len]
    assert g.info["captured"] and g.info["replays"] == 1, g.info
    assert eng._decode_chunk.info["captured"]
    res.update(metrics=eng.metrics(label=label).to_dict(),
               admission_graph=dict(g.info),
               chunk_graph=dict(eng._decode_chunk.info),
               serve_peak_gb=_gb_peak())
    eng.kv.write_prefill(params, prompt[None], 0)
    _, ref = prefill(params, cfg, prompt_d, cache_len=rows)
    st, want = eng.kv.data["ssm_state"], ref["ssm_state"]
    res["state_vs_classic_prefill"] = {
        name: {"bitwise": torch.equal(st[name], want[name]),
               "max_abs_err": (st[name].float() - want[name].float())
               .abs().max().item()} for name in st}
    assert all(v["bitwise"] for v in res["state_vs_classic_prefill"]
               .values()), res["state_vs_classic_prefill"]
    del eng, g, ref, st, want
    torch.cuda.empty_cache()

    def steps(record=None, edit=None, last_cfg=None):
        """The request fed eagerly on a fresh cache: every step's logits
        (the admission's first) and the stream; ``record`` gets the last
        step's mixer rows, ``edit`` the cache before that step, which
        runs under ``last_cfg`` if given."""
        cache = init_cache(cfg, 1, rows, device="cuda")
        logits, _ = prefill_into_slot(params, cfg, prompt_d, cache, 0)
        outs, stream = [logits.float()], [int(logits.argmax(-1))]
        for i in range(new - 1):
            last = i == new - 2
            if last and edit is not None:
                edit(cache)
            c = last_cfg if last and last_cfg is not None else cfg
            with attn_rows(record) if last and record is not None \
                    else contextlib.nullcontext():
                logits, _ = decode_step(
                    params, c, torch.tensor([[tokens[i]]], device="cuda"),
                    cache, torch.tensor([prompt_len + i], device="cuda"))
            outs.append(logits.float())
            stream.append(int(logits.argmax(-1)))
        return outs, stream

    got_rows, full_rows = [], []
    got, stream = steps(got_rows)
    assert stream == tokens, f"{label}: eager steps and the engine differ"
    fed = torch.as_tensor(np.concatenate(
        [prompt, np.asarray(tokens[:-1], np.int32)])[None], device="cuda")
    with attn_rows(full_rows):
        hidden = forward(params, cfg, fed)
    full = logits_of(params, cfg, hidden[:, prompt_len - 1:])[0].float()
    del hidden
    assert full.shape[0] == len(got) == new
    teacher = [(gl, full[i:i + 1]) for i, gl in enumerate(got)]
    res["vs_full_forward"] = {"logits": hold_logits(teacher),
                              "attn": attn_gap(got_rows, full_rows)}
    assert check_ok(res["vs_full_forward"]), (label, res["vs_full_forward"])
    with plain_versions():
        plain, _ = steps()
    res["vs_plain"] = hold_logits(list(zip(got, plain)))

    def zero_ssm(cache):
        cache["ssm_state"]["ssm"].zero_()

    controls = {"zeroed_ssm_state": dict(edit=zero_ssm)}
    if cfg.attn_type == "hybrid":
        # a window wider than the cache: the decode layer takes its cache
        # for a ring and attends over every row written
        controls["no_window"] = dict(
            last_cfg=dataclasses.replace(cfg, local_window=10 ** 9))
    res["controls"] = {}
    for name, kw in controls.items():
        bad_rows = []
        bad, _ = steps(bad_rows, **kw)
        c = res["controls"][name] = {
            "logits": logit_stats([(bad[-1], full[-1:])]),
            "attn": attn_gap(bad_rows, full_rows)}
        c["weak"] = check_ok(c)
        assert not c["weak"], (label, name, c)
    return res


def report_ssm_long(label, r, card) -> None:
    m, ag, chk = r["metrics"], r["admission_graph"], r["vs_full_forward"]
    print(f"{label} long request on {card}: {r['prompt']} + "
          f"{r['new_tokens']} tokens, cache {r['cache_rows']} rows; TTFT "
          f"{m['ttft_p50'] * 1e3:.3f} ms (replayed admission), per-token "
          f"p50 {m['tok_latency_p50'] * 1e3:.3f} ms; admission capture "
          f"{ag['capture_ms']:.1f} ms + instantiate "
          f"{ag['instantiate_ms']:.1f} ms, pool "
          f"{ag['pool_bytes'] / 2**20:.1f} MiB; peak "
          f"{r['serve_peak_gb']:.2f} GB; state after admission vs classic "
          f"prefill {r['state_vs_classic_prefill']}; every step's logits "
          f"vs teacher-forced forward {chk['logits']}, mixer rows "
          f"{chk['attn']}; vs plain {r['vs_plain']}; controls "
          + "; ".join(f"{k}: logits {c['logits']}, mixer rows "
                      f"{c['attn']['max_rel_rms_err']:.4f} with "
                      f"{c['attn']['layers_over']} of "
                      f"{len(c['attn']['per_layer'])} over "
                      f"({'weak' if c['weak'] else 'fails as it must'})"
                      for k, c in r["controls"].items())
          + f"; launches {r['counts']}", flush=True)


#: (1) of the MoE checks: fed the plain run's input to a layer, the
#: router's probabilities through the kernels are held to the plain ones
#: within this RMS of their difference over their RMS
ROUTER_TOL = 0.01
#: (1): fed the plain run's input, a layer's kernels may take other
#: experts than plain only where plain's probabilities make the kernels'
#: experts a top-k within this margin.  A difference of at most e in each
#: probability can swap two experts only where they lie within 2e; the
#: largest teacher-forced difference measured at moonshot on the H100 was
#: 3.6e-5 (PERF.md), so 2e = 7.3e-5, rounded up
ROUTE_MARGIN = 1e-4
#: (2): with plain's routes pinned, each must be a top-k of the kernels'
#: own router within this margin: the pin settles near-ties and nothing
#: else.  Along the layers the runs' hidden states drift apart by
#: rounding, which teacher forcing resets at every layer, so the routers
#: differ more than in (1) (7.8e-4 at most at moonshot on the H100) and
#: the widest near-tie a pin settled there was 1.45e-4 (PERF.md): twice
#: that, rounded up
PIN_MARGIN = 3e-4
#: the MoE checks' prompts: 32 tokens (the SpMM at admission) and 16 (the
#: decode kernels), as :func:`logit_parity`'s
MOE_PROMPTS = (32, 16)
#: (4): the admission whose dropped slots are printed, layer by layer
MOE_DROP_PROMPT = 64


def route_misses(probs, eidx, margin: float) -> int:
    """Tokens whose experts ``eidx`` [T, k] are not a top-k of ``probs``
    [T, E] within ``margin``: the least probability among the experts
    taken lies below the greatest among the others by more than
    ``margin``."""
    taken = probs.gather(1, eidx).min(1).values
    others = probs.scatter(1, eidx, float("-inf")).max(1).values
    return int((taken < others - margin).sum())


def _same_experts(a, b):
    """[T] whether each token took the same set of experts in a and b."""
    return (a.sort(1).values == b.sort(1).values).all(1)


def _own_top_k(probs, k: int):
    import torch

    return torch.sort(probs, stable=True, dim=-1,
                      descending=True).indices[:, :k]


def moe_layers(cfg, params) -> dict:
    """The MoE check (1), layer by layer and teacher forced: each layer of
    ``params`` (n:m:g attention) is fed the plain run's input and run
    through the kernels and through the plain versions, at the prompts of
    :data:`MOE_PROMPTS`.  Held: the attention output, every position,
    within :data:`ATTN_TOL` (:func:`attn_gap`); the router's
    probabilities within :data:`ROUTER_TOL` of their RMS; and where the
    kernels take other experts than plain, plain's probabilities must
    make the kernels' experts a top-k within :data:`ROUTE_MARGIN`.  Every
    other flip fails.  The control: the kernels' experts relabelled by a
    derangement must fall outside the margin."""
    import numpy as np
    import torch

    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    k = cfg.moe.top_k
    perm = _derangement(cfg.moe.num_experts, 26)
    rng = np.random.default_rng(1)
    got_a, want_a, calls = [], [], []
    for S in MOE_PROMPTS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)),
                               device="cuda")
        x = tf._embed(params, cfg, toks)
        for lp in tf.layer_list(params["layers"]):
            def layer(x=x, lp=lp):
                rows = []
                with attn_rows(rows, last=False), moe.route_log() as log:
                    x1, _ = tf._sublayer_attn(lp, x, cfg)
                    out, _ = tf._sublayer_ffn(lp, x1, cfg)
                (a,), (call,) = rows, log.calls
                return a, call, out

            with plain_versions():
                a_p, c_p, x_next = layer()
            a_k, c_k, _ = layer()
            got_a.append(a_k)
            want_a.append(a_p)
            calls.append((c_k, c_p))
            x = x_next
    n = cfg.n_layers * len(MOE_PROMPTS)
    assert len(calls) == n, (len(calls), n)
    abs_err = [(c_k["probs"] - c_p["probs"]).abs().max().item()
               for c_k, c_p in calls]
    rel = [((c_k["probs"] - c_p["probs"]).norm()
            / c_p["probs"].norm()).item() for c_k, c_p in calls]
    flips = [int((~_same_experts(c_k["eidx"], c_p["eidx"])).sum())
             for c_k, c_p in calls]
    bad = sum(route_misses(c_p["probs"], c_k["eidx"], ROUTE_MARGIN)
              for c_k, c_p in calls)
    ctl = sum(route_misses(c_p["probs"], perm[c_k["eidx"]], ROUTE_MARGIN)
              for c_k, c_p in calls)
    gaps = []   # plain's k-th minus (k+1)-th probability at each flip
    for (c_k, c_p), f in zip(calls, flips):
        if f:
            top = torch.sort(c_p["probs"], dim=-1, descending=True).values
            d = ~_same_experts(c_k["eidx"], c_p["eidx"])
            gaps += (top[d, k - 1] - top[d, k]).tolist()
    res = {"layers_compared": n, "tokens": sum(MOE_PROMPTS),
           "routes": sum(c_k["eidx"].shape[0] for c_k, _ in calls),
           "attn": attn_gap(got_a, want_a),
           "router_max_abs_err": max(abs_err),
           "router_max_rel_rms_err": max(rel), "router_tol": ROUTER_TOL,
           "margin": ROUTE_MARGIN, "flipped_tokens": sum(flips),
           "flip_gaps": gaps, "flips_outside_margin": bad,
           "control_outside_margin": ctl}
    assert res["attn"]["layers_over"] == 0, res
    assert max(rel) <= ROUTER_TOL, res
    assert bad == 0, res
    assert ctl > 0, f"relabelled experts pass the margin: {res}"
    return res


@contextlib.contextmanager
def moe_rows(into: list):
    """While inside, append to ``into`` every MoE sublayer's output at the
    last position (before any post-norm), [B, D] in f32, in call order:
    one a layer, a forward's last row or a decode step's row.  Eager
    programs only, as :func:`attn_rows`."""
    from repro_torch.models import moe

    fn = moe.apply_moe

    def rec(*args, **kw):
        out = fn(*args, **kw)
        into.append(out[0][:, -1].float())
        return out

    moe.apply_moe = rec
    try:
        yield into
    finally:
        moe.apply_moe = fn


@contextlib.contextmanager
def ulp_embeddings(seed: int):
    """While inside, every token embedding the model computes (bf16) is
    moved by one unit in its last place, up, down or not at all at
    random (seeded): a perturbation of rounding's size at the model's
    input.  A run through the plain versions under it, beside the plain
    run, shows how far the model itself carries one rounding step to its
    logits: the floor under any two bf16 evaluations' difference."""
    import torch

    from repro_torch.models import transformer as tf

    fn = tf._embed
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def moved(*args, **kw):
        x = fn(*args, **kw)
        assert x.dtype == torch.bfloat16, x.dtype
        step = torch.randint(-1, 2, x.shape, generator=gen, device=x.device,
                             dtype=torch.int16).masked_fill_(x == 0, 0)
        return (x.view(torch.int16) + step).view(torch.bfloat16)

    tf._embed = moved
    try:
        yield
    finally:
        tf._embed = fn


def _derangement(E: int, seed: int):
    """A seeded permutation of the E experts that moves every one."""
    import torch

    g = torch.Generator().manual_seed(seed)
    while True:
        perm = torch.randperm(E, generator=g)
        if bool((perm != torch.arange(E)).all()):
            return perm.to("cuda")


def moe_parity(cfg, params) -> dict:
    """The MoE checks (2) and (3), end to end with the routes pinned: the
    prompts of :data:`MOE_PROMPTS` each prefilled and 4 decode steps
    through the plain versions, every MoE layer's experts recorded
    (``models/moe.py:route_log``); then the same steps through the kernels
    fed the same tokens with those experts pinned, held by the 5% rule
    of :func:`logit_stats` (:func:`hold_logits`') and, at each step,
    every MoE layer's output at the last position within :data:`ATTN_TOL`
    of the plain run's (:func:`moe_rows`, :func:`attn_gap`): with random weights
    a token's logits are mostly its own embedding (x sqrt(d_model)), and
    the experts reach them too little for the logit rule alone to see
    which experts ran.  The kernels' router under the pin is held to the
    plain run's probabilities call for call within :data:`ROUTER_TOL` of
    their RMS, and each pinned choice must be a top-k of the kernels' own
    router within :data:`PIN_MARGIN`: the pin settles near-ties and
    nothing else.  How many lie outside :data:`ROUTE_MARGIN`, (1)'s, is
    reported.  The control pins a shuffled copy of the recorded routes
    (the experts relabelled by a derangement): it must fail the check
    (:func:`check_ok`) and fall outside :data:`PIN_MARGIN`; whether it
    fails the logit rule alone is reported.  Reported too, the floor: the
    plain run again, routes pinned, under :func:`ulp_embeddings`."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, moe, prefill

    k, E = cfg.moe.top_k, cfg.moe.num_experts
    perm = _derangement(E, 26)
    rng = np.random.default_rng(1)
    pairs, bad_pairs, want_rows, got_rows, bad_rows = [], [], [], [], []
    floor_pairs, floor_rows = [], []
    both = []   # (the pinned run's call, the plain run's), call for call
    shuffled = []   # the control's calls
    for S in MOE_PROMPTS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)),
                               device="cuda")

        def steps(feed=None):
            logits, cache = prefill(params, cfg, toks, cache_len=S + 8)
            out, fed = [logits.float()], []
            tok = torch.argmax(logits, -1)[:, None]
            for i in range(4):
                if feed is not None:
                    tok = feed[i]
                fed.append(tok)
                logits, cache = decode_step(params, cfg, tok, cache,
                                            torch.tensor(S + i, device="cuda"))
                out.append(logits.float())
                tok = torch.argmax(logits, -1)[:, None]
            return out, fed

        with plain_versions(), moe.route_log() as rec, moe_rows(want_rows):
            want, fed = steps()
        with moe.route_log(pin=rec.routes) as pin, moe_rows(got_rows):
            got, _ = steps(fed)
        assert len(pin.calls) == len(rec.calls) == 5 * cfg.n_layers, \
            (len(pin.calls), len(rec.calls))
        both += zip(pin.calls, rec.calls)
        with moe.route_log(pin=[perm[r] for r in rec.routes]) as ctl, \
                moe_rows(bad_rows):
            bad, _ = steps(fed)
        assert len(ctl.calls) == len(rec.calls)
        with plain_versions(), moe.route_log(pin=rec.routes), \
                moe_rows(floor_rows), ulp_embeddings(S):
            floor, _ = steps(fed)
        shuffled += ctl.calls
        pairs += list(zip(got, want))
        bad_pairs += list(zip(bad, want))
        floor_pairs += list(zip(floor, want))
    abs_err = max((c["probs"] - r["probs"]).abs().max().item()
                  for c, r in both)
    rel = max(((c["probs"] - r["probs"]).norm()
               / r["probs"].norm()).item() for c, r in both)
    gaps = []   # the kernels' own k-th minus (k+1)-th where they differ
    for c, _ in both:
        d = ~_same_experts(c["eidx"], _own_top_k(c["probs"], k))
        if d.any():
            top = torch.sort(c["probs"], dim=-1, descending=True).values
            gaps += (top[d, k - 1] - top[d, k]).tolist()
    res = logit_stats(pairs)
    res.update(
        pinned_routes=sum(c["eidx"].shape[0] for c, _ in both),
        pinned_unlike_own_top_k=len(gaps), own_gaps=gaps,
        router_max_abs_err=abs_err, router_max_rel_rms_err=rel,
        router_tol=ROUTER_TOL, margin=PIN_MARGIN,
        pinned_outside_margin=sum(route_misses(c["probs"], c["eidx"],
                                               PIN_MARGIN)
                                  for c, _ in both),
        teacher_forced_margin=ROUTE_MARGIN,
        pinned_outside_teacher_forced_margin=sum(
            route_misses(c["probs"], c["eidx"], ROUTE_MARGIN)
            for c, _ in both),
        moe_rows=attn_gap(got_rows, want_rows),
        control={"logits": logit_stats(bad_pairs),
                 "attn": attn_gap(bad_rows, want_rows),
                 "outside_margin": sum(route_misses(c["probs"], c["eidx"],
                                                    PIN_MARGIN)
                                       for c in shuffled)},
        floor={"logits": logit_stats(floor_pairs),
               "attn": attn_gap(floor_rows, want_rows)})
    assert rel <= ROUTER_TOL and res["pinned_outside_margin"] == 0, res
    assert check_ok({"logits": res, "attn": res["moe_rows"]}), res
    assert not check_ok(res["control"]), f"shuffled routes pass: {res}"
    assert res["control"]["outside_margin"] > 0, \
        f"shuffled routes pass the margin: {res}"
    return res


def moe_drops(cfg, params) -> dict:
    """The MoE check (4): one admission of :data:`MOE_DROP_PROMPT` tokens,
    each layer's dropped slots (the reference's capacity rule at work, not
    a fault), each count held to the rule's own: per expert, the slots
    past its capacity."""
    import numpy as np
    import torch

    from repro_torch.models import init_cache, moe, prefill_into_slot

    S, mc = MOE_DROP_PROMPT, cfg.moe
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, S)), device="cuda")
    cache = init_cache(cfg, 1, S, device="cuda")
    with moe.route_log() as log:
        prefill_into_slot(params, cfg, toks, cache, 0)
    cap = moe.capacity(S, mc)
    dropped = [int((~c["keep"]).sum()) for c in log.calls]
    want = [int((torch.bincount(c["eidx"].reshape(-1),
                                minlength=mc.num_experts) - cap)
                .clamp_min(0).sum()) for c in log.calls]
    assert len(dropped) == cfg.n_layers and dropped == want, (dropped, want)
    return {"tokens": S, "slots": S * mc.top_k, "capacity": cap,
            "dropped_per_layer": dropped}


def _graph_span_ms(fn) -> float:
    """The device span of ``fn`` captured as one CUDA graph: CUDA events
    around each of 5 replays, the median (after one warm replay)."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                   # the eager first run (workspaces, libraries)
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    for s_, e_ in zip(starts, ends):
        torch.cuda.synchronize()
        s_.record()
        g.replay()
        e_.record()
    torch.cuda.synchronize()
    del g
    return statistics.median(s_.elapsed_time(e_)
                             for s_, e_ in zip(starts, ends))


def moe_cost(cfg, params) -> dict:
    """Where a MoE model's decode step spends its time, without a
    profiler: the device span (:func:`_graph_span_ms`) of every layer's
    MoE sublayer at a decode step's 4 tokens, and of its two batched
    expert products alone (on the capacity buffer of that step), beside
    the experts' bytes at 3.35 TB/s.  Set beside the decode chunk's span
    a step (:func:`graph_phase`)."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    mc, D, dt = cfg.moe, cfg.d_model, cfg.tdtype
    E, F, B = mc.num_experts, mc.d_expert, 4
    cap = moe.capacity(B, mc)
    ps = [lp["moe"] for lp in tf.layer_list(params["layers"])]
    gen = torch.Generator(device="cuda").manual_seed(27)
    x = torch.randn(B, 1, D, generator=gen, device="cuda").to(dt)
    buf = torch.randn(E, cap, D, generator=gen, device="cuda").to(dt)
    hbuf = torch.randn(E, cap, F, generator=gen, device="cuda").to(dt)

    def sublayers():
        for p in ps:
            moe.apply_moe(p, x, cfg)

    def products():
        for p in ps:
            torch.bmm(buf, p["wi"])
            torch.bmm(hbuf, p["wo"])

    expert_bytes = sum(p["wi"].numel() * p["wi"].element_size()
                       + p["wo"].numel() * p["wo"].element_size()
                       for p in ps)
    return {"tokens": B, "capacity": cap, "layers": len(ps),
            "moe_sublayers_ms": _graph_span_ms(sublayers),
            "expert_products_ms": _graph_span_ms(products),
            "expert_bytes": expert_bytes,
            "expert_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3}


def moe_phase(cfg, params) -> dict:
    """The MoE checks on n:m:g ``params``: (1) :func:`moe_layers`, (2) and
    (3) :func:`moe_parity`, (4) :func:`moe_drops`; then the cost of the
    MoE sublayers and their expert products (:func:`moe_cost`)."""
    return {"layers": moe_layers(cfg, params),
            "parity": moe_parity(cfg, params),
            "drops": moe_drops(cfg, params), "cost": moe_cost(cfg, params)}


# ---------------------------------------------------------------------------
# phase 3j: whisper-large-v3 (enc-dec: an encoder over 1500 frames,
# cross-attention over cross K/V held per slot)
# ---------------------------------------------------------------------------

#: a request's frame embeddings: 30 s of audio at 50 Hz after the stub
#: frontend (``configs/whisper_large_v3.py:ENC_LEN``)
ENC_FRAMES = 1500
#: the full-context request: the decoder's published 448 positions
#: (openai/whisper-large-v3 ``max_target_positions``) as 224 prompt tokens
#: and 224 new tokens, in a 2-slot cache of 448 rows
FULL_PROMPT, FULL_NEW, FULL_ROWS = 224, 224, 448


def encdec_frames(cfg, seed: int, frames: int = 0):
    """One request's frame embeddings [1, frames (default
    :data:`ENC_FRAMES`), D]: N(0, 1) from a seeded generator on the card,
    in the model dtype (the encoder norms them first, so their scale is
    the frontend's business)."""
    import torch

    frames = frames or ENC_FRAMES
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(1, frames, cfg.d_model, generator=gen,
                       device="cuda").to(cfg.tdtype)


def cross_kv_bytes(cfg, slots: int) -> int:
    """Bytes of the cross K/V of ``slots`` slots (``xk`` and ``xv`` of
    every decoder layer, the model dtype): a decode step reads them once.
    A size from the config, not a measurement."""
    return (2 * cfg.n_layers * slots * ENC_FRAMES * cfg.n_kv_heads * cfg.hd
            * cfg.tdtype.itemsize)


def encdec_serve(cfg, params, label, *, graphs: bool) -> dict:
    """The trace (:func:`requests_for`: 8 requests, prompts 32/24/64/16,
    32 new tokens, all due at once), each request with its own seeded
    frames, served by a loop of this script's own over a
    ``SlotKVCache(cfg, 4, 96, enc_len=1500)`` (the engine takes no
    encoder inputs): a request is admitted eagerly by
    ``prefill_into_slot(enc_embeds=)`` into the lowest free slot, its
    first token the admission's argmax; then the engine's 8-step greedy
    chunk program (``_decode_chunk_fn`` in a ``DecodeGraph``, replayed
    with ``graphs``, else eager) decodes every slot, one host fetch a
    chunk, tokens past a request's end discarded, as the engine's loop
    does.  Warmed first with one 2-token request per prompt length (the
    chunk's capture); the counts are zeroed right before the measured
    run and read right after.  The cache keeps its storage throughout.
    Returns the engine's metrics (``serve/metrics.py``), counts, streams
    and each admission's wall time."""
    import numpy as np
    import torch

    from repro_torch.models import prefill_into_slot
    from repro_torch.models.transformer import cache_leaves
    from repro_torch.serve import Request, SlotKVCache
    from repro_torch.serve.engine import _decode_chunk_fn
    from repro_torch.serve.graphs import DecodeGraph
    from repro_torch.serve.metrics import summarize
    from repro_torch.serve.queue import RequestOutput

    B, T = ENGINE_KW["max_slots"], ENGINE_KW["decode_chunk"]
    kv = SlotKVCache(cfg, B, ENGINE_KW["max_seq_len"], enc_len=ENC_FRAMES,
                     device="cuda", graphs=False)
    pool = torch.cuda.graph_pool_handle() if graphs else None
    chunk = DecodeGraph(_decode_chunk_fn(cfg, T), params, kv.data, B,
                        name="decode_chunk", capture=graphs, pool=pool)
    ptrs = [t.data_ptr() for t in cache_leaves(kv.data)]
    trace = requests_for(cfg)
    warm = [Request(uid=100 + i, prompt=r.prompt, max_new_tokens=2)
            for i, r in enumerate(trace[:len(PROMPT_LENS)])]
    frames = {r.uid: encdec_frames(cfg, 1000 + r.uid) for r in trace + warm}

    def serve(reqs):
        t0 = time.perf_counter()

        def now():
            return time.perf_counter() - t0

        queue, slots = list(reqs), [None] * B
        pos, tok = np.zeros(B, np.int32), np.zeros(B, np.int32)
        outs, admit_ms, steps = [], [], 0

        def finish(s):
            st = slots[s]
            outs.append(RequestOutput(
                uid=st["req"].uid, prompt_len=int(st["req"].prompt.size),
                tokens=st["tokens"], finish_reason="length",
                arrival_time=0.0, admitted_time=st["admitted"],
                finish_time=now(), token_times=st["times"]))
            slots[s] = None
            pos[s] = tok[s] = 0

        while queue or any(s is not None for s in slots):
            for s in range(B):
                if slots[s] is None and queue:
                    r = queue.pop(0)
                    ta = now()
                    logits, _ = prefill_into_slot(
                        params, cfg, torch.as_tensor(r.prompt[None],
                                                     device="cuda"),
                        kv.data, s, enc_embeds=frames[r.uid])
                    first = int(logits[0].argmax())
                    admit_ms.append((now() - ta) * 1e3)
                    slots[s] = {"req": r, "tokens": [first],
                                "times": [now()], "admitted": ta}
                    pos[s], tok[s] = r.prompt.size, first
            active = [s for s in range(B) if slots[s] is not None]
            tc0 = now()
            block = chunk.run(tok, pos).cpu().numpy()
            tc1 = now()
            steps += T
            for s in active:
                st = slots[s]
                for t in range(T):
                    st["tokens"].append(int(block[t, s]))
                    st["times"].append(tc0 + (t + 1) * (tc1 - tc0) / T)
                    pos[s] += 1
                    tok[s] = block[t, s]
                    if len(st["tokens"]) >= st["req"].max_new_tokens:
                        finish(s)
                        break
        return sorted(outs, key=lambda o: o.uid), now(), admit_ms, steps

    serve(warm)
    torch.cuda.synchronize()
    reset_counts()
    outs, wall, admit_ms, steps = serve(trace)
    torch.cuda.synchronize()
    counts = read_counts()
    assert [t.data_ptr() for t in cache_leaves(kv.data)] == ptrs, label
    assert len(outs) == 8 and all(len(o.tokens) == 32 for o in outs), label
    assert all(0 <= t < cfg.vocab for o in outs for t in o.tokens)
    assert not any(k.endswith("/plain") for k in counts["routes"]), counts
    assert chunk.info["captured"] == graphs, chunk.info
    return {"metrics": summarize(outs, wall, label=label).to_dict(),
            "counts": counts, "tokens": [o.tokens for o in outs],
            "decode_steps": steps,
            "admission_wall_ms": admit_ms,
            "chunk_graph": dict(chunk.info)}


def encdec_serve_phase(cfg, params, label) -> dict:
    """:func:`encdec_serve` replayed and eager: token streams and launch
    counts (replays included) equal."""
    g = encdec_serve(cfg, params, label, graphs=True)
    e = encdec_serve(cfg, params, label, graphs=False)
    assert g["tokens"] == e["tokens"], f"{label}: streams differ"
    assert g["counts"] == e["counts"], (label, g["counts"], e["counts"])
    return {"label": label, "metrics": g["metrics"],
            "eager_metrics": e["metrics"], "counts": g["counts"],
            "decode_steps": g["decode_steps"],
            "chunk_graph": g["chunk_graph"],
            "admission_wall_ms": {"graph": g["admission_wall_ms"],
                                  "eager": e["admission_wall_ms"]},
            "first_tokens": [t[:4] for t in g["tokens"]]}


def encdec_admission(cfg, params, label) -> dict:
    """One 32-token admission with its frames into slot 2 of a 4-slot
    cache: wall time (median of 5, ending in the logits' host fetch),
    eager, and the device span of the same admission and of the encoder
    alone, each captured as one CUDA graph (:func:`_graph_span_ms`), with
    the launches of one admission."""
    import numpy as np
    import torch

    from repro_torch.models import init_cache, prefill_into_slot
    from repro_torch.models import transformer as tf

    cache = init_cache(cfg, 4, 96, enc_len=ENC_FRAMES, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab, (1, 32)), device="cuda")
    frames = encdec_frames(cfg, 11)
    slot = torch.tensor(2, device="cuda")   # no host copy under capture

    def admit():
        return prefill_into_slot(params, cfg, toks, cache, slot,
                                 enc_embeds=frames)[0]

    def one():
        t0 = time.perf_counter()
        admit().cpu()
        return time.perf_counter() - t0

    one()
    wall = statistics.median(one() for _ in range(5))
    torch.cuda.synchronize()
    reset_counts()
    admit()
    torch.cuda.synchronize()
    launches = read_counts()
    return {"label": label, "prompt": 32, "frames": ENC_FRAMES,
            "eager_wall_ms": wall * 1e3,
            "span_ms": _graph_span_ms(admit),
            "encoder_span_ms": _graph_span_ms(
                lambda: tf._run_encoder(params, cfg, frames, cfg.tdtype)),
            "launches": {k: launches[k] for k in KERNELS}}


def xattn_cost(cfg, params) -> dict:
    """Where a decode step's cross-attention goes, without a profiler:
    the device span (:func:`_graph_span_ms`) of every decoder layer's
    cross-attention sublayer at a step's 4 tokens over 4 slots of seeded
    cross K/V (1500 frames), and of its attention alone (the
    ``chunked_attention`` call: the f32 casts and repeats of ``xk`` /
    ``xv``, scores, softmax, values), beside the cross K/V's bytes at
    3.35 TB/s.  Set beside the decode chunk's span a step
    (:func:`graph_phase`)."""
    import torch

    from repro_torch.models import attention
    from repro_torch.models import transformer as tf

    B, L, dt = ENGINE_KW["max_slots"], cfg.n_layers, cfg.tdtype
    gen = torch.Generator(device="cuda").manual_seed(28)
    shape = (L, B, ENC_FRAMES, cfg.n_kv_heads, cfg.hd)
    xk = torch.randn(shape, generator=gen, device="cuda").to(dt)
    xv = torch.randn(shape, generator=gen, device="cuda").to(dt)
    x = torch.randn(B, 1, cfg.d_model, generator=gen, device="cuda").to(dt)
    q = torch.randn(B, 1, cfg.n_heads, cfg.hd, generator=gen,
                    device="cuda").to(dt)
    ps = [lp["xattn"] for lp in tf.layer_list(params["layers"])]

    def sublayers():
        for i, p in enumerate(ps):
            tf._cross_attn_cached(p, x, xk[i], xv[i], cfg)

    def attention_alone():
        for i in range(L):
            attention.chunked_attention(q, xk[i], xv[i], causal=False,
                                        chunk_q=cfg.attn_chunk_q)

    nbytes = cross_kv_bytes(cfg, B)
    assert nbytes == (xk.numel() + xv.numel()) * xk.element_size()
    return {"tokens": B, "frames": ENC_FRAMES, "layers": L,
            "xattn_sublayers_ms": _graph_span_ms(sublayers),
            "xattn_attention_ms": _graph_span_ms(attention_alone),
            "cross_kv_bytes": nbytes,
            "cross_kv_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


@contextlib.contextmanager
def encdec_rows(self_rows: list, cross_rows: list):
    """While inside, append each decoder layer's self-attention output
    (before any post-norm) and cross-attention output at the last
    position of batch row 0, [1, D] in f32, in call order: a forward's
    (``apply_gqa`` outside the encoder; ``_cross_attn_cached``, which
    ``_cross_attn`` calls) and a decode step's (``_decode_gqa_at``,
    ``_cross_attn_cached``), one each per layer.  The encoder's layers
    are skipped.  Eager programs only: a graph replay records nothing."""
    from repro_torch.models import attention
    from repro_torch.models import transformer as tf

    saved = {(attention, "apply_gqa"): attention.apply_gqa,
             (tf, "_decode_gqa_at"): tf._decode_gqa_at,
             (tf, "_cross_attn_cached"): tf._cross_attn_cached,
             (tf, "_run_encoder"): tf._run_encoder}
    inside = [False]

    def recorder(fn, into, part):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            if not inside[0]:
                a = out if part is None else out[part]
                into.append(a[0:1, -1].float())
            return out
        return rec

    def encoder(*args, **kw):
        inside[0] = True
        try:
            return saved[(tf, "_run_encoder")](*args, **kw)
        finally:
            inside[0] = False

    attention.apply_gqa = recorder(saved[(attention, "apply_gqa")],
                                   self_rows, 0)
    tf._decode_gqa_at = recorder(saved[(tf, "_decode_gqa_at")], self_rows,
                                 None)
    tf._cross_attn_cached = recorder(saved[(tf, "_cross_attn_cached")],
                                     cross_rows, None)
    tf._run_encoder = encoder
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


@contextlib.contextmanager
def causal_encoder():
    """While inside, the encoder's layers attend causally (a control: the
    frames seen as a prefix-free sequence)."""
    from repro_torch.models import transformer as tf

    run, sub = tf._run_encoder, tf._sublayer_attn

    def causal_run(*args, **kw):
        tf._sublayer_attn = lambda *a, **k: sub(*a, **{**k, "causal": True})
        try:
            return run(*args, **kw)
        finally:
            tf._sublayer_attn = sub

    tf._run_encoder = causal_run
    try:
        yield
    finally:
        tf._run_encoder = run


def encdec_full_context(cfg, params, label) -> dict:
    """One request of :data:`FULL_PROMPT` tokens and :data:`FULL_NEW` new
    ones at :data:`FULL_ROWS` rows (the decoder's whole published
    context) in slot 0 of a 2-slot cache whose slot 1 holds a 32-token
    request with other frames: both admitted eagerly with their frames,
    then decoded by the engine's chunk program replayed (27 chunks of 8)
    and its single-step program replayed (the last 7 steps).  Checks,
    each against bounds fixed here:

    - the slot's ``xk`` / ``xv`` right after admission bitwise an eager
      classic ``prefill``'s of the same request;
    - the same tokens (both slots') fed through eager ``decode_step`` on a
      fresh cache give the replayed streams and, at the last step,
      bitwise the replayed logits; every step's logits (the admission's
      and each decode step's) held by :func:`hold_logits` against one
      teacher-forced ``forward`` over the prompt and the fed tokens with
      the same frames;
    - at the last step each decoder layer's self-attention and
      cross-attention output (:func:`encdec_rows`) within
      :data:`ATTN_TOL` of the forward's (:func:`attn_gap`).

    Controls, each of which must fail the cross-attention rows: the last
    step decoded with the slot's ``xk`` / ``xv`` zeroed, or with the
    other slot's copied in (another request's frames), and the forward
    run with a causal encoder."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, forward, init_cache, \
        logits_of, prefill, prefill_into_slot
    from repro_torch.models.transformer import cache_leaves, map_cache
    from repro_torch.serve.engine import _decode_chunk_fn, _decode_fn
    from repro_torch.serve.graphs import DecodeGraph

    rng = np.random.default_rng(12)
    prompt = rng.integers(0, cfg.vocab, FULL_PROMPT, dtype=np.int32)
    other = rng.integers(0, cfg.vocab, 32, dtype=np.int32)
    prompt_d = torch.as_tensor(prompt[None], device="cuda")
    other_d = torch.as_tensor(other[None], device="cuda")
    fa, fb = encdec_frames(cfg, 12), encdec_frames(cfg, 13)
    new, rows = FULL_NEW, FULL_ROWS
    chunks = (new - 1) // 8
    singles = new - 1 - 8 * chunks
    res = {"label": label, "prompt": FULL_PROMPT, "new_tokens": new,
           "cache_rows": rows, "frames": ENC_FRAMES}

    def admit(cache):
        lo, _ = prefill_into_slot(params, cfg, other_d, cache, 1,
                                  enc_embeds=fb)
        la, _ = prefill_into_slot(params, cfg, prompt_d, cache, 0,
                                  enc_embeds=fa)
        return la, lo

    torch.cuda.reset_peak_memory_stats()
    cache = init_cache(cfg, 2, rows, enc_len=ENC_FRAMES, device="cuda")
    ptrs = [t.data_ptr() for t in cache_leaves(cache)]
    pool = torch.cuda.graph_pool_handle()
    chunk = DecodeGraph(_decode_chunk_fn(cfg, 8), params, cache, 2,
                        name="decode_chunk", pool=pool)
    step = DecodeGraph(_decode_fn(cfg), params, cache, 2, pool=pool)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    la, lo = admit(cache)
    streams = [[int(la[0].argmax())], [int(lo[0].argmax())]]
    t1 = time.perf_counter()
    _, ref = prefill(params, cfg, prompt_d, cache_len=rows, enc_embeds=fa)
    res["cross_kv_vs_classic_prefill"] = {
        name: torch.equal(cache[name][:, 0], ref[name][:, 0])
        for name in ("xk", "xv")}
    assert all(res["cross_kv_vs_classic_prefill"].values()), res
    del ref
    tok = np.array([streams[0][0], streams[1][0]], np.int32)
    pos = np.array([FULL_PROMPT, 32], np.int32)
    t2 = time.perf_counter()
    for _ in range(chunks):
        blk = chunk.run(tok, pos).cpu().numpy()
        for s in range(2):
            streams[s] += [int(t) for t in blk[:, s]]
        tok, pos = blk[-1].astype(np.int32), pos + 8
    for _ in range(singles):
        last = step.run(tok, pos)
        tok = last.argmax(-1).int().cpu().numpy()
        for s in range(2):
            streams[s].append(int(tok[s]))
        pos = pos + 1
    replayed = last[0:1].float().clone()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    assert chunk.info["replays"] == chunks - 1 and \
        step.info["replays"] == singles - 1, (chunk.info, step.info)
    assert [t.data_ptr() for t in cache_leaves(cache)] == ptrs
    tokens = streams[0]
    assert len(tokens) == new
    res.update(admission_ms=(t1 - t0) * 1e3, counts=read_counts(),
               decode_ms_per_step=(t3 - t2) * 1e3 / (new - 1),
               chunk_graph=dict(chunk.info), step_graph=dict(step.info),
               serve_peak_gb=_gb_peak())
    del cache, chunk, step
    torch.cuda.empty_cache()

    # the same tokens fed eagerly on a fresh cache, up to the last step
    cache = init_cache(cfg, 2, rows, enc_len=ENC_FRAMES, device="cuda")
    la, lo = admit(cache)
    got = [la.float()]
    for i in range(new - 2):
        feed = torch.tensor([[streams[0][i]], [streams[1][i]]],
                            device="cuda")
        logits, _ = decode_step(params, cfg, feed, cache, torch.tensor(
            [FULL_PROMPT + i, 32 + i], device="cuda"))
        got.append(logits[0:1].float())
        for s in range(2):
            assert int(logits[s].argmax()) == streams[s][i + 1], (label, i)
    before_last = map_cache(torch.clone, cache)
    feed = torch.tensor([[streams[0][new - 2]], [streams[1][new - 2]]],
                        device="cuda")
    last_pos = torch.tensor([FULL_PROMPT + new - 2, 32 + new - 2],
                            device="cuda")

    def last_step(edit=None, record=None):
        c = map_cache(torch.clone, before_last)
        if edit is not None:
            edit(c)
        with encdec_rows(*record) if record else contextlib.nullcontext():
            logits, _ = decode_step(params, cfg, feed, c, last_pos)
        return logits[0:1].float()

    got_self, got_cross = [], []
    got.append(last_step(record=(got_self, got_cross)))
    assert torch.equal(got[-1], replayed), f"{label}: replay differs"
    fed = torch.as_tensor(np.concatenate(
        [prompt, np.asarray(tokens[:-1], np.int32)])[None], device="cuda")

    def full_forward(record):
        with encdec_rows(*record):
            hidden = forward(params, cfg, fed, enc_embeds=fa)
        return logits_of(params, cfg, hidden[:, FULL_PROMPT - 1:])[0].float()

    full_self, full_cross = [], []
    full = full_forward((full_self, full_cross))
    assert full.shape[0] == len(got) == new
    teacher = [(g, full[i:i + 1]) for i, g in enumerate(got)]
    res["vs_full_forward"] = {
        "logits": hold_logits(teacher),
        "self_attn": attn_gap(got_self, full_self),
        "cross_attn": attn_gap(got_cross, full_cross)}
    chk = res["vs_full_forward"]
    assert chk["self_attn"]["layers_over"] == 0, (label, chk)
    assert chk["cross_attn"]["layers_over"] == 0, (label, chk)

    def zero_cross(c):
        c["xk"][:, 0].zero_()
        c["xv"][:, 0].zero_()

    def other_frames(c):
        c["xk"][:, 0].copy_(c["xk"][:, 1])
        c["xv"][:, 0].copy_(c["xv"][:, 1])

    res["controls"] = {}
    for name, edit in (("zeroed_cross_kv", zero_cross),
                       ("other_slot_cross_kv", other_frames)):
        bad_self, bad_cross = [], []
        bad = last_step(edit, (bad_self, bad_cross))
        res["controls"][name] = {
            "logits": logit_stats([(bad, full[-1:])]),
            "cross_attn": attn_gap(bad_cross, full_cross)}
    causal_self, causal_cross = [], []
    with causal_encoder():
        causal = full_forward((causal_self, causal_cross))
    res["controls"]["causal_encoder"] = {
        "logits": logit_stats([(got[-1], causal[-1:])]),
        "cross_attn": attn_gap(got_cross, causal_cross)}
    for name, c in res["controls"].items():
        c["weak"] = c["cross_attn"]["layers_over"] == 0
        assert not c["weak"], (label, name, c)
    return res


def report_encdec(label, r, card) -> None:
    adm, cost, fc = r["admissions"], r["xattn_cost"], r["full_context"]
    for a in adm:
        print(f"{a['label']} admission on {card}: {a['prompt']} tokens over "
              f"{a['frames']} frames, eager {a['eager_wall_ms']:.3f} ms wall, "
              f"device span {a['span_ms']:.3f} ms (encoder "
              f"{a['encoder_span_ms']:.3f} ms), launches {a['launches']}",
              flush=True)
    print(f"{label} cross-attention on {card}: a decode step's "
          f"{cost['layers']} sublayers at {cost['tokens']} tokens over "
          f"{cost['frames']} frames {cost['xattn_sublayers_ms']:.3f} ms, "
          f"their attention alone {cost['xattn_attention_ms']:.3f} ms "
          f"(device spans of one graph each); the cross K/V's "
          f"{cost['cross_kv_bytes'] / 1e9:.3f} GB at 3.35 TB/s "
          f"{cost['cross_kv_bound_ms']:.3f} ms", flush=True)
    chk = fc["vs_full_forward"]
    print(f"{label} full-context request on {card}: {fc['prompt']} + "
          f"{fc['new_tokens']} tokens at {fc['cache_rows']} rows beside "
          f"another slot; admission {fc['admission_ms']:.3f} ms (eager), "
          f"decode {fc['decode_ms_per_step']:.3f} ms a step (replayed); "
          f"peak {fc['serve_peak_gb']:.2f} GB; cross K/V vs classic "
          f"prefill {fc['cross_kv_vs_classic_prefill']}; every step's "
          f"logits vs teacher-forced forward {chk['logits']}, self-attention "
          f"rows {chk['self_attn']['max_rel_rms_err']:.5f}, cross-attention "
          f"rows {chk['cross_attn']['max_rel_rms_err']:.5f} (bound "
          f"{ATTN_TOL}); controls "
          + "; ".join(f"{k}: cross rows "
                      f"{c['cross_attn']['max_rel_rms_err']:.4f} with "
                      f"{c['cross_attn']['layers_over']} of "
                      f"{len(c['cross_attn']['per_layer'])} over, logits "
                      f"{c['logits']['max_abs_err']:.4f} "
                      f"({'weak' if c['weak'] else 'fails as it must'})"
                      for k, c in fc["controls"].items())
          + f"; launches {fc['counts']}", flush=True)


def encdec_phase(cfg, params, sparse, short, card, res) -> dict:
    """Phase (j)'s serving of an enc-dec model (``res`` holds
    :func:`family_phase`'s init and conversion): dense and n:m:g each
    through :func:`encdec_serve_phase` (the trace replayed and eager) and
    :func:`graph_phase` over a cache with cross K/V (the 8-step chunk
    replay bitwise eager across an admission), their admissions timed
    (:func:`encdec_admission`); beside per-token p50 the step's byte
    bound: the weights a decode step reads (``xattn.wk`` / ``wv`` left
    out: they run at admission only) and the cross K/V of 4 slots, read
    once.  Then on the n:m:g copy: the logits against the plain versions
    (:func:`logit_parity`, with frames), the cross-attention's cost
    (:func:`xattn_cost`) and the full-context request
    (:func:`encdec_full_context`)."""
    import torch

    from repro_torch.core.layouts import GroupedNMTensor

    def converted(tree):
        if isinstance(tree, dict):
            return sum(converted(v) for v in tree.values())
        return int(isinstance(tree, GroupedNMTensor))

    # the encoder's q/k/v/o and MLP, the decoder's and its xattn's
    res["converted_leaves"] = converted(sparse)
    assert res["converted_leaves"] == 16, res["converted_leaves"]
    cross = cross_kv_bytes(cfg, ENGINE_KW["max_slots"])
    res["step_bytes"]["cross_kv"] = cross
    torch.cuda.reset_peak_memory_stats()
    runs, graphs, adm = [], [], []
    for kind, p in (("dense", params), ("sparse", sparse)):
        label = f"{short}_{kind}"
        runs.append(encdec_serve_phase(cfg, p, label))
        graphs.append(graph_phase(cfg, p, label, profile=False,
                                  enc_len=ENC_FRAMES))
        adm.append(encdec_admission(cfg, p, label))
    res["serve_peak_gb"] = _gb_peak()
    dc, sc = runs[0]["counts"], runs[1]["counts"]
    assert all(dc[k] == 0 for k in KERNELS), dc
    for k in ("nmg_gemv", "nmg_qkv", "nmg_spmm"):
        assert sc[k] > 0, f"{k} never launched on the {short} n:m:g path"
    assert sc["nmg_ffn"] == 0, sc          # whisper's MLP is not gated
    report_runs(runs, card)
    for r in runs:
        kind = r["label"].rsplit("_", 1)[1]
        adm_ms = r["admission_wall_ms"]["graph"]
        r["step_bound_ms"] = ((res["step_bytes"][kind] + cross)
                              / HBM_BYTES_PER_S * 1e3)
        print(f"serve[{r['label']}] on {card}: per-token p50 "
              f"{r['metrics']['tok_latency_p50'] * 1e3:.3f} ms (graphs), "
              f"weights read a decode step {res['step_bytes'][kind] / 1e9:.3f}"
              f" GB, cross K/V read {cross / 1e9:.3f} GB, byte bound "
              f"{r['step_bound_ms']:.3f} ms at 3.35 TB/s; admissions "
              f"(eager) {[round(a, 3) for a in adm_ms]} ms", flush=True)
    for p in graphs:
        cg = p["chunk_graph"]
        print(f"decode chunk[{p['label']}] on {card}: 8 steps at 4 slots, "
              f"replay bitwise eager ({p['bitwise']}); eager "
              f"{p['eager_wall_ms']:.2f} ms wall, replayed "
              f"{p['replay_wall_ms']:.3f} ms wall, device (event span) "
              f"{p['replay_event_span_ms']:.3f} ms; capture "
              f"{cg['capture_ms']:.1f} ms + instantiate "
              f"{cg['instantiate_ms']:.1f} ms, pool "
              f"{cg['pool_bytes'] / 2**20:.1f} MiB", flush=True)
    res["parity"] = logit_parity(cfg, sparse, frames=ENC_FRAMES)
    print(f"logit parity ({cfg.name} attn=True gr{res['gr']}, kernels vs "
          f"plain, with frames): {res['parity']}", flush=True)
    res["encdec"] = {"admissions": adm, "xattn_cost": xattn_cost(cfg, sparse),
                     "full_context": encdec_full_context(
                         cfg, sparse, f"{short}_full_context")}
    report_encdec(cfg.name, res["encdec"], card)
    res["runs"], res["graphs"] = runs, graphs
    return res


def family_phase(arch: str, smoke: bool, gr: int, card: str) -> dict:
    """One model at full width and depth, or with ``smoke`` its SMOKE
    config (seeded random weights, bf16): ``init_lm`` (seconds, peak),
    the n:m:g 1:4:8 ``attn=True`` conversion with ``gr`` group rows
    (seconds, peak), then dense and n:m:g each through
    :func:`serve_phase` (graphs and eager: streams and counts equal, each
    length's admission replay bitwise eager) and :func:`graph_phase`
    (the 8-step chunk replay bitwise eager, wall eager and replayed, the
    replay's CUDA-event span as its device time: no profiler session runs
    in this process), the n:m:g logits held against the plain versions
    (:func:`logit_parity`), and for gemma2 :func:`window_phase`, for
    paligemma :func:`prefix_phase`, for minicpm3 :func:`latent_phase`,
    for an SSM model :func:`ssm_long_request`.
    A MoE or SSM model also runs :func:`prefill_phase`
    without profiles (each admission length replayed bitwise eager, its
    wall, dense and n:m:g), and a MoE model's logits are held by
    :func:`moe_phase` in place of :func:`logit_parity` (near-ties in the
    router make two runs take other experts somewhere in 48 layers).
    n:m:g converts a MoE model's attention alone (``sparsify_for_serving``'s
    globs match no expert), an attention-free model's mixer projections
    (:func:`ssm_sparsify`).  Beside per-token p50 stands the step's byte
    bound: the weights one decode step reads (:func:`step_weight_bytes`)
    and twice the recurrent state (:func:`ssm_state_bytes`: read and
    written) at 3.35 TB/s."""
    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import init_lm
    from repro_torch.serve import sparsify_for_serving

    cfg = get_smoke(arch) if smoke else get_config(arch)
    short = arch.split("-")[0]
    label = f"{arch} at SMOKE" if smoke else arch
    depth = PHASE_DEPTH.get(arch) if not smoke else None
    if depth is not None:
        dec, enc = depth if isinstance(depth, tuple) else (depth, 0)
        label = (f"{arch} at {dec} of {cfg.n_layers} layers" if not enc else
                 f"{arch} at {enc} + {dec} of {cfg.n_enc_layers} + "
                 f"{cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=dec,
                                  **({"n_enc_layers": enc} if enc else {}))
    gc.collect()               # the previous model's engines and graphs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    res = {"arch": arch, "smoke": smoke, "label": label,
           "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
           "init_s": time.perf_counter() - t0,
           "init_peak_gb": _gb_peak(),
           "param_gb": torch.cuda.memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sparse = (ssm_sparsify(params, gr) if cfg.attn_type == "none" else
              sparsify_for_serving(params, 1, 4, 8, gr=gr, attn=True))
    torch.cuda.synchronize()
    res.update(convert_s=time.perf_counter() - t0, gr=gr,
               convert_peak_gb=_gb_peak(),
               step_bytes={"dense": step_weight_bytes(params),
                           "sparse": step_weight_bytes(sparse),
                           "state": ssm_state_bytes(
                               cfg, ENGINE_KW["max_slots"])})
    print(f"{label} on {card}: init {res['init_s']:.2f} s, peak "
          f"{res['init_peak_gb']:.2f} GB ({res['param_gb']:.2f} GB of "
          f"params); n:m:g conversion {res['convert_s']:.2f} s, peak "
          f"{res['convert_peak_gb']:.2f} GB", flush=True)
    if cfg.moe is not None:
        res["step_bytes"]["moe"] = moe_step_bytes(cfg, params)
    if cfg.n_enc_layers > 0:
        return encdec_phase(cfg, params, sparse, short, card, res)
    torch.cuda.reset_peak_memory_stats()
    runs = [serve_phase(cfg, params, f"{short}_dense")]
    graphs = [graph_phase(cfg, params, f"{short}_dense", profile=False)]
    prefills = []
    timed_admissions = cfg.moe is not None or cfg.ssm is not None
    if timed_admissions:
        prefills.append(prefill_phase(cfg, params, f"{short}_dense",
                                      profile=False))
    del params                 # the n:m:g copy is served alone
    torch.cuda.empty_cache()
    runs.append(serve_phase(cfg, sparse, f"{short}_sparse"))
    graphs.append(graph_phase(cfg, sparse, f"{short}_sparse", profile=False))
    if timed_admissions:
        prefills.append(prefill_phase(cfg, sparse, f"{short}_sparse",
                                      profile=False))
    res["serve_peak_gb"] = _gb_peak()
    dc, sc = runs[0]["counts"], runs[1]["counts"]
    assert all(dc[k] == 0 for k in KERNELS), dc
    for k in ("nmg_gemv", "nmg_spmm"):
        assert sc[k] > 0, f"{k} never launched on the {label} n:m:g path"
    # a GQA (or hybrid) model's q/k/v take the fused launch; MLA has no
    # q/k/v group (its latent projections stay dense), mamba2 no attention
    gqa = cfg.attn_type in ("gqa", "hybrid")
    assert (sc["nmg_qkv"] > 0) == gqa, (arch, sc)
    # a MoE layer has no mlp.wi, a pure SSM layer no MLP: no fused FFN
    has_mlp = cfg.moe is None and cfg.attn_type != "none"
    assert (sc["nmg_ffn"] > 0) == (cfg.gated_mlp and has_mlp), sc
    report_runs(runs, card)
    state = res["step_bytes"]["state"]
    for r in runs:
        kind = r["label"].rsplit("_", 1)[1]
        # an SSM step reads and writes its recurrent state once
        r["step_bound_ms"] = ((res["step_bytes"][kind] + 2 * state)
                              / HBM_BYTES_PER_S * 1e3)
        print(f"serve[{r['label']}] on {card}: per-token p50 "
              f"{r['metrics']['tok_latency_p50'] * 1e3:.3f} ms (graphs), "
              f"weights read a decode step {res['step_bytes'][kind] / 1e9:.2f}"
              f" GB, state read and written {state / 1e9:.3f} GB each, "
              f"byte bound {r['step_bound_ms']:.3f} ms at 3.35 TB/s")
    for p in graphs:
        cg = p["chunk_graph"]
        print(f"decode chunk[{p['label']}] on {card}: 8 steps at 4 slots, "
              f"replay bitwise eager ({p['bitwise']}); eager "
              f"{p['eager_wall_ms']:.2f} ms wall, replayed "
              f"{p['replay_wall_ms']:.3f} ms wall, device (event span) "
              f"{p['replay_event_span_ms']:.3f} ms; capture "
              f"{cg['capture_ms']:.1f} ms + instantiate "
              f"{cg['instantiate_ms']:.1f} ms, pool "
              f"{cg['pool_bytes'] / 2**20:.1f} MiB")
    print(f"{label} serving peak device memory on {card}: "
          f"{res['serve_peak_gb']:.2f} GB", flush=True)
    if prefills:
        report_prefill(prefills, card)
        res["prefill"] = prefills
    if cfg.moe is None:
        res["parity"] = logit_parity(cfg, sparse)
    else:
        res["moe"] = moe_phase(cfg, sparse)
        res["parity"] = res["moe"]["parity"]
        report_moe(label, res["moe"], card)
    print(f"logit parity ({label} attn=True gr{gr}, kernels vs plain"
          f"{', routes pinned' if cfg.moe else ''}): {res['parity']}",
          flush=True)
    if cfg.layer_pattern == "alt_local_global":
        w = res["window"] = window_phase(cfg, sparse)
        ag, m = w["admission_graph"], w["metrics"]
        print(f"{label} window request on {card}: prompt {WINDOW_PROMPT} + "
              f"{WINDOW_NEW} tokens, rings of {cfg.local_window} rows, "
              f"global {WINDOW_SEQ}; TTFT {m['ttft_p50'] * 1e3:.3f} ms "
              f"(replayed admission), per-token p50 "
              f"{m['tok_latency_p50'] * 1e3:.3f} ms; admission capture "
              f"{ag['capture_ms']:.1f} ms + instantiate "
              f"{ag['instantiate_ms']:.1f} ms, pool "
              f"{ag['pool_bytes'] / 2**20:.1f} MiB; peak "
              f"{w['serve_peak_gb']:.2f} GB; last logits vs full forward "
              f"{w['vs_full_forward']}, vs plain {w['vs_plain']}; cache "
              f"rows vs classic prefill {w['rows_vs_prefill']}; controls "
              f"{w['controls']}", flush=True)
    if cfg.ssm is not None:
        r = res["long"] = ssm_long_request(cfg, sparse, f"{short}_long")
        report_ssm_long(label, r, card)
    requests = {}
    if cfg.vision_prefix:
        requests["prefix"] = prefix_phase
    if cfg.attn_type == "mla":
        requests["latent"] = latent_phase
    for key, fn in requests.items():
        r = res[key] = fn(cfg, sparse)
        want = [k for k in KERNELS if gqa or k != "nmg_qkv"]
        assert all(r["counts"][k] > 0 for k in want), (key, r["counts"])
        chk, ctl = r["vs_full_forward"], r["control"]
        print(f"{label} {key} request on {card}: {r['prefix_rows']} "
              f"prefix rows + {r['prompt']} + {r['new_tokens']} tokens, "
              f"cache {r['cache_rows']} rows; "
              + (f"TTFT {r['metrics']['ttft_p50'] * 1e3:.3f} ms "
                 f"(replayed admission), per-token p50 "
                 f"{r['metrics']['tok_latency_p50'] * 1e3:.3f} ms; "
                 if "metrics" in r else
                 f"admission {r['admission_ms']:.3f} ms (eager), "
                 f"decode {r['decode_s'] * 1e3:.1f} ms for "
                 f"{r['new_tokens'] - 1} steps (captures included); ")
              + f"peak {r['serve_peak_gb']:.2f} GB; last logits vs full "
              f"forward {chk['logits']}, attention rows "
              f"{chk['attn']}; vs plain {r['vs_plain']}; control "
              f"logits {ctl['logits']}, attention rows {ctl['attn']}; "
              f"launches {r['counts']}", flush=True)
    res["runs"], res["graphs"] = runs, graphs
    return res


def moe_step_bytes(cfg, params) -> dict:
    """The MoE leaves' share of :func:`step_weight_bytes`, held to the
    config: all E experts of every layer (the batched product reads
    every expert at every step) and the f32 router."""
    mc, L, D = cfg.moe, cfg.n_layers, cfg.d_model
    m = params["layers"]["moe"]
    got = {k: t.numel() * t.element_size() for k, t in m.items()}
    F2 = (2 if cfg.gated_mlp else 1) * mc.d_expert
    assert got["router"] == L * D * mc.num_experts * 4, got
    assert got["wi"] + got["wo"] == L * mc.num_experts * (
        D * F2 + mc.d_expert * D) * cfg.tdtype.itemsize, got
    assert sum(got.values()) <= step_weight_bytes(params), got
    return got


def report_moe(arch, r, card) -> None:
    lay, par, drops = r["layers"], r["parity"], r["drops"]
    print(f"{arch} MoE on {card}: (1) layer by layer, teacher forced, "
          f"{lay['layers_compared']} layers x prompts {MOE_PROMPTS}: "
          f"attention {lay['attn']['max_rel_rms_err']:.5f} (bound "
          f"{ATTN_TOL}), router probabilities max abs "
          f"{lay['router_max_abs_err']:.3e}, rel RMS "
          f"{lay['router_max_rel_rms_err']:.3e} (bound {ROUTER_TOL}), "
          f"{lay['flipped_tokens']} of {lay['routes']} tokens took other "
          f"experts (plain's k-th minus (k+1)-th there "
          f"{[f'{g:.2e}' for g in lay['flip_gaps']]}), "
          f"{lay['flips_outside_margin']} outside the margin "
          f"{lay['margin']:.1e}; control: the kernels' experts relabelled, "
          f"{lay['control_outside_margin']} outside it", flush=True)
    ctl = par["control"]
    print(f"{arch} MoE on {card}: (2) routes pinned, logits "
          f"{par['max_abs_err']:.4f} (bound {par['tol']:.4f}, argmax "
          f"{par['argmax_agree']}), MoE rows "
          f"{par['moe_rows']['max_rel_rms_err']:.5f} (bound {ATTN_TOL}); "
          f"router probabilities max abs {par['router_max_abs_err']:.3e}, "
          f"rel RMS {par['router_max_rel_rms_err']:.3e} (bound "
          f"{ROUTER_TOL}); {par['pinned_routes']} pinned routes, "
          f"{par['pinned_unlike_own_top_k']} unlike the kernels' own "
          f"top-k (own k-th minus (k+1)-th there "
          f"{[f'{g:.2e}' for g in par['own_gaps']]}), "
          f"{par['pinned_outside_margin']} outside the margin "
          f"{par['margin']:.1e}, "
          f"{par['pinned_outside_teacher_forced_margin']} outside (1)'s "
          f"{par['teacher_forced_margin']:.1e} (reported); (3) shuffled "
          f"control: {ctl['outside_margin']} routes outside the margin, "
          f"logits {ctl['logits']['max_abs_err']:.4f} "
          f"(argmax {ctl['logits']['argmax_agree']}, the logit rule "
          f"{'passed' if ctl['logits']['ok'] else 'failed'}), MoE rows "
          f"{ctl['attn']['max_rel_rms_err']:.4f} with "
          f"{ctl['attn']['layers_over']} of "
          f"{len(ctl['attn']['per_layer'])} over: fails as it must; floor "
          f"(plain, one ulp at the input): logits "
          f"{par['floor']['logits']['max_abs_err']:.4f} (argmax "
          f"{par['floor']['logits']['argmax_agree']}), MoE rows "
          f"{par['floor']['attn']['max_rel_rms_err']:.5f}; (4) "
          f"{drops['tokens']}-token admission, capacity "
          f"{drops['capacity']} of {drops['slots']} slots, dropped per "
          f"layer {drops['dropped_per_layer']}", flush=True)
    c = r["cost"]
    print(f"{arch} MoE cost on {card}: a decode step's {c['layers']} MoE "
          f"sublayers at {c['tokens']} tokens (capacity {c['capacity']}) "
          f"{c['moe_sublayers_ms']:.3f} ms, their expert products alone "
          f"{c['expert_products_ms']:.3f} ms (device spans of one graph "
          f"each); the experts' {c['expert_bytes'] / 1e9:.2f} GB at "
          f"3.35 TB/s {c['expert_bound_ms']:.3f} ms", flush=True)


def families_child(flag: str, extra=()) -> int:
    """Phase 3d (``python3 chip_smoke.py --families``), 3e
    (``--vlm-mla``), 3h (``--moe``), 3i (``--ssm``), 3j (``--encdec``)
    or 3k (``--kvcache``: :func:`kvcache_phase`) in its own process,
    started by :func:`main`: the earlier phases' params, graphs, pools
    and profiler sessions are not in it.  With :data:`GO_FLAG` among
    ``extra`` it readies itself and waits for "go" on its standard input
    (:func:`run_children`).  Writes its results to ``chiprun_out/`` under
    the flag's file name (:data:`FAMILY_RUNS`)."""
    import torch

    from repro_torch.kernels import _build

    archs, name = FAMILY_RUNS[flag]
    wait = GO_FLAG in extra
    extra = [x for x in extra if x != GO_FLAG]
    assert torch.cuda.is_available(), f"{flag} needs a CUDA device"
    card = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(("nmg_gemv", "nmg_spmm", "nmg_ffn"))
    torch.zeros(1, device="cuda")        # the CUDA context, made now
    if wait and sys.stdin.readline().strip() != "go":
        return 1                         # the parent ended without it
    t0 = time.perf_counter()
    if flag == "--kvcache":
        res = kvcache_phase(card)
    elif flag == "--slo":
        res = slo_phase(card)
    elif flag == "--check":
        res = check_phase(card, float(extra[0]))
    elif flag == "--dist":
        res = dist_phase(card)
        res["o"] = dryrun_phase(card)
    else:
        res = {"families": [family_phase(a, smoke, gr, card)
                            for a, smoke, gr in archs]}
    res["wall_s"] = time.perf_counter() - t0
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / name).write_text(json.dumps(res, indent=1))
    return 0


#: a child started with this argument readies itself (imports, the CUDA
#: context, its kernels) and then waits for "go" on its standard input
GO_FLAG = "--wait-for-go"


def run_children(children) -> dict:
    """Run :func:`families_child` for each ``(flag, timeout, extra)`` of
    ``children`` in turn, each in a process of its own, and return what
    each wrote, by flag.  The next child is started while one runs and
    waits, ready, for its turn (:data:`GO_FLAG`), so that a child's
    start-up (about 12 s on the H100's host) runs beside the phase before
    it; nothing a phase times runs before its "go".  Raises if a child
    fails or outlasts its ``timeout`` s from its turn; every child
    started is ended."""
    def start(flag, extra):
        (ROOT / "chiprun_out" / FAMILY_RUNS[flag][1]).unlink(missing_ok=True)
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), flag, *extra,
             GO_FLAG], stdin=subprocess.PIPE, text=True)

    procs = [start(children[0][0], children[0][2])]
    out = {}
    try:
        for i, (flag, timeout, _) in enumerate(children):
            if i + 1 < len(children):
                procs.append(start(children[i + 1][0], children[i + 1][2]))
            procs[i].stdin.write("go\n")
            procs[i].stdin.close()
            rc = procs[i].wait(timeout=timeout)
            if rc != 0:
                raise subprocess.CalledProcessError(rc, procs[i].args)
            lap(flag.lstrip("-"))
            out[flag] = json.loads(
                (ROOT / "chiprun_out" / FAMILY_RUNS[flag][1]).read_text())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


# ---------------------------------------------------------------------------
# phase 3k: the int8 KV cache and paged serving (qwen1.5-4b, minicpm3-4b)
# ---------------------------------------------------------------------------

#: the paged engines' page size, and the (k2) shared prefix and suffixes
PAGE_SIZE = 16
SHARED_PREFIX, SHARED_SUFFIXES = 64, (16, 19, 23, 26, 30, 33, 37, 40)
#: the fixed check's teacher-forced request: prompt and decode steps
FIXED_PROMPT, FIXED_STEPS = 64, 32
#: (k5)'s long run: four prompts of this many tokens, 32 new each, in
#: slots of LONG_SEQ rows
LONG_PROMPT, LONG_SEQ = 1536, 2048
#: minicpm3-4b's depth in phase (k), of its 62 layers: every layer writes
#: and reads its int8 latents through the same code, which (k4) holds per
#: write and per step; phase (e) serves it at 8.  At 62
#: layers the minicpm3 part of (k) took 34 s of its 119 on an H100, which
#: the smoke's 1200 s limit cannot spare
KV_MLA_LAYERS = 16


def cache_bytes(cache) -> int:
    from repro_torch.models.transformer import cache_leaves

    return sum(t.numel() * t.element_size() for t in cache_leaves(cache))


def slot_rows(tree, slot, n) -> list:
    """The first ``n`` rows of ``slot`` in every sequence leaf [L, B, S,
    ...] of a cache tree (the state leaves' slot row)."""
    if isinstance(tree, dict):
        return [r for k in sorted(tree) for r in slot_rows(tree[k], slot, n)]
    return [tree[:, slot, :n] if tree.ndim >= 3 else tree[:, slot]]


def same_rows(a, b) -> bool:
    import torch

    return len(a) == len(b) > 0 and all(torch.equal(x, y)
                                        for x, y in zip(a, b))


def kv_serve(cfg, params, label, requests, built=None, eng=None,
             **ekw) -> dict:
    """``requests`` through a ``ServeEngine(**ENGINE_KW, **ekw)`` replaying
    its programs, warmed first (``warmup_engine``), with the launch
    counts zeroed right before the measured run and read right after;
    with ``eng``, through that engine as it stands (its programs built by
    an earlier run, its metrics cleared).  With ``built`` the warm-up
    must have built exactly those programs and the measured run none.
    Every request must finish with all its tokens, on no plain route.
    Returns (the run's record, the engine)."""
    import torch

    from repro_torch.serve import ServeEngine, warmup_engine
    from repro_torch.serve.tracecount import reset_trace_events, \
        trace_events

    t0 = time.perf_counter()
    reset_trace_events()
    if eng is None:
        eng = ServeEngine(params, cfg, **dict(ENGINE_KW, **ekw))
        warmup_engine(eng, requests)
    else:
        eng.reset_metrics()
    warm = trace_events()
    warm_s = time.perf_counter() - t0
    if built is not None:
        assert warm == built, (label, warm, built)
    torch.cuda.synchronize()
    reset_counts()
    outs = eng.run(requests)
    torch.cuda.synchronize()
    counts = read_counts()
    if built is not None:
        assert trace_events() == built, (label, trace_events())
    assert [o.uid for o in outs] == [r.uid for r in requests], label
    for o, r in zip(outs, requests):
        assert o.finish_reason == "length" \
            and len(o.tokens) == r.max_new_tokens, (label, o.uid, o.tokens)
        assert all(0 <= t < cfg.vocab for t in o.tokens)
    assert not any(k.endswith("/plain") for k in counts["routes"]), counts
    res = {"label": label, "tokens": [o.tokens for o in outs],
           "metrics": eng.metrics(label=label).to_dict(), "counts": counts,
           "stats": dict(eng.stats), "trace_events": warm,
           "cache_bytes": cache_bytes(eng.kv.data),
           "chunk_graph": dict(eng._decode_chunk.info),
           "warm_s": warm_s, "wall_s": time.perf_counter() - t0}
    if eng.paged:
        res["kv_stats"] = dict(eng.kv.stats)
        res["num_pages"] = eng.kv.num_pages
        assert eng.kv.alloc.pages_in_use() == 0, label   # drained
    return res, eng


def replay_span_ms(graph) -> float:
    """A captured program's device span: CUDA events around each of 3
    replays of its graph, the median."""
    import torch

    starts = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for s_, e_ in zip(starts, ends):
        torch.cuda.synchronize()
        s_.record()
        graph.graph.replay()
        e_.record()
    torch.cuda.synchronize()
    return statistics.median(s_.elapsed_time(e_)
                             for s_, e_ in zip(starts, ends))


def span_turns(runs: dict, engines: dict) -> None:
    """Each engine's replayed chunk span (:func:`replay_span_ms`), the
    engines taken in turns (a, b, b, a, a, b for two): the median of its
    three readings goes to ``runs[label]["chunk_span_ms"]``.  Two layouts
    or cache dtypes are compared only within one such set of turns."""
    order = list(engines) + list(engines)[::-1] + list(engines)
    got: dict = {lab: [] for lab in engines}
    for lab in order:
        got[lab].append(replay_span_ms(engines[lab]._decode_chunk))
    for lab, v in got.items():
        runs[lab]["chunk_span_ms"] = statistics.median(v)
        runs[lab]["chunk_spans_ms"] = v


def paged_programs(cfg, params, label, eng) -> dict:
    """The paged engine ``eng``'s programs at the cache level, once its
    trace has drained, beside a slot cache of its shape (4 slots of 96
    rows, pages of 16, chunk 8).  Its warm-up built every program used
    here, so each paged run below is a replay of what the engine served
    with (eager where the engine does not capture):

    - four seeded prompts of the trace's lengths (32, 24, 64, 16 tokens)
      admitted into the engine's pool and the slot cache (which runs
      eagerly): logits bitwise, and every slot's rows read through the
      page table (``logical_view``) bitwise the slot cache's;
    - each length's admission again into its slot, replayed, bitwise the
      eager admission program on a clone of the pool (logits, pool);
    - three 8-step chunks, the first in both caches (rows bitwise the slot
      cache's after it), each later one replayed on the live pool and run
      eagerly on a clone (tokens and pools bitwise), with an admission (a
      24-token prompt into slot 1) after the second; two single steps
      the same way; every pool leaf's storage kept throughout."""
    import numpy as np
    import torch

    from repro_torch.models import init_cache, prefill_into_slot
    from repro_torch.models.transformer import cache_leaves, map_cache
    from repro_torch.serve.cache import _paged_prefill_fn
    from repro_torch.serve.engine import _decode_chunk_fn, \
        _paged_decode_chunk_fn, _paged_decode_fn

    t0 = time.perf_counter()
    pk, chunk, step = eng.kv, eng._decode_chunk, eng._decode
    B, T, S_c = pk.max_slots, eng.decode_chunk, pk.max_seq_len
    assert (B, T, S_c, pk.page_size) == (4, 8, 96, PAGE_SIZE), label
    assert pk.alloc.pages_in_use() == 0, label          # drained
    replays = (chunk.info["replays"], step.info["replays"])
    rng = np.random.default_rng(4)

    def d(x):
        return torch.as_tensor(x, device="cuda")

    prompts = [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
               for n in PROMPT_LENS]
    sk = init_cache(cfg, B, S_c, device="cuda")
    ptrs = [t.data_ptr() for t in cache_leaves(pk.data)]
    for slot, p in enumerate(prompts):
        a = prefill_into_slot(params, cfg, torch.as_tensor(p, device="cuda"),
                              sk, slot)[0]
        b = pk.admit(params, p, slot).clone()
        assert torch.equal(a, b), f"{label}: admission logits, slot {slot}"
    view = pk.logical_view()
    for slot, p in enumerate(prompts):
        assert same_rows(slot_rows(sk, slot, p.shape[1]),
                         slot_rows(view, slot, p.shape[1])), (label, slot)
    del view
    # each length's admission replayed, against the eager program
    fn = _paged_prefill_fn(cfg, PAGE_SIZE, pk.num_pages)
    for slot, p in enumerate(prompts):
        pk.release_slot(slot)
        ref = map_cache(torch.clone, pk.data)
        got = pk.admit(params, p, slot).clone()
        info = pk.prefill_graphs[p.shape[1]].info
        assert info["replays"] >= 1 or not info["captured"], info
        want = fn(params, d(p), ref, d(pk.table[slot]), d(np.int32(slot)),
                  d(np.int32(0)))
        assert torch.equal(got, want), f"{label}: admission S={p.shape[1]}"
        assert same_cache(pk.data, ref), f"{label}: admission pool"
    del ref
    tok = np.zeros(B, np.int32)
    pos = np.array([p.shape[1] for p in prompts], np.int32)
    chunk_fn = _paged_decode_chunk_fn(cfg, PAGE_SIZE, pk.num_pages, T)
    step_fn = _paged_decode_fn(cfg, PAGE_SIZE, pk.num_pages)

    def pages(n):
        for slot in range(B):
            assert pk.ensure_writable_range(slot, int(pos[slot]), n)

    def eager(fn, ref):
        return fn(params, d(tok[:, None]), ref, d(pk.table), d(pos))

    # the first chunk in both caches: tokens and rows bitwise
    pages(T)
    a = _decode_chunk_fn(cfg, T)(params, d(tok[:, None]), sk, d(pos))
    b = chunk.run(tok, pos, pk.table).clone()
    assert torch.equal(a, b), f"{label}: first chunk tokens"
    view = pk.logical_view()
    for slot in range(B):
        n = int(pos[slot]) + T
        assert same_rows(slot_rows(sk, slot, n),
                         slot_rows(view, slot, n)), (label, "chunk", slot)
    del view, sk
    tok, pos = b[-1].cpu().numpy().copy(), pos + T
    for turn in range(2):
        pages(T)
        ref = map_cache(torch.clone, pk.data)
        got = chunk.run(tok, pos, pk.table).clone()
        want = eager(chunk_fn, ref)
        assert torch.equal(got, want), f"{label}: replayed chunk {turn}"
        assert same_cache(pk.data, ref), f"{label}: chunk {turn} pool"
        tok, pos = got[-1].cpu().numpy().copy(), pos + T
        if turn == 0:
            pk.release_slot(1)
            p = rng.integers(0, cfg.vocab, (1, 24), dtype=np.int32)
            ref = map_cache(torch.clone, pk.data)
            lg = pk.admit(params, p, 1).clone()
            want = fn(params, d(p), ref, d(pk.table[1]), d(np.int32(1)),
                      d(np.int32(0)))
            assert torch.equal(lg, want), f"{label}: admission after chunk"
            assert same_cache(pk.data, ref), label
            tok[1], pos[1] = int(lg.argmax()), 24
    for turn in range(2):
        pages(1)
        ref = map_cache(torch.clone, pk.data)
        got = step.run(tok, pos, pk.table).clone()
        want = eager(step_fn, ref)
        assert torch.equal(got, want), f"{label}: replayed step {turn}"
        assert same_cache(pk.data, ref), f"{label}: step {turn} pool"
        tok, pos = got.argmax(-1).int().cpu().numpy(), pos + 1
    del ref
    if chunk.capture_on:     # the chunk captured in the warm-up; the step
        # captured there or at its first run here
        assert chunk.info["replays"] == replays[0] + 3, chunk.info
        assert step.info["replays"] >= replays[1] + 1, step.info
    assert [t.data_ptr() for t in cache_leaves(pk.data)] == ptrs, label
    return {"label": label, "bitwise": "4 admissions (rows), each length "
            "replayed, 3 chunks (admission after the second), 2 steps",
            "chunk_graph": dict(chunk.info),
            "wall_s": time.perf_counter() - t0}


@contextlib.contextmanager
def kv_store(kind: str):
    """How the cache stores a K/V or latent tile, for the fixed check:
    ``"fake"`` quantizes and dequantizes every float write
    (``_dq_cache(_q_cache(x))``, in the model dtype) into a model-dtype
    cache; ``"bare"`` (the control) replaces the quantizer with a bare
    ``.to(torch.int8)`` (truncation, wrap-around, no scale)."""
    import torch

    from repro_torch.models import transformer as tf

    to_cache, quantize = tf._to_cache_dtype, tf._quantize

    def fake(piece, dst_dtype):
        assert dst_dtype.is_floating_point, dst_dtype
        return (quantize(piece).to(dst_dtype)
                * tf._dq_scale(dst_dtype)).to(dst_dtype)

    if kind == "fake":
        tf._to_cache_dtype = fake
    else:
        tf._quantize = lambda x: x.to(torch.int8)
    try:
        yield
    finally:
        tf._to_cache_dtype, tf._quantize = to_cache, quantize


def fixed_check(cfg, params, label) -> dict:
    """The fixed check of the int8 rule: one request of FIXED_PROMPT
    tokens and FIXED_STEPS teacher-forced decode steps (its tokens
    seeded), each step replayed from a captured one-step program: every
    step's logits with the int8 cache are bitwise the logits over a
    model-dtype cache into which every write was first fake-quantized
    (``_dq_cache(_q_cache(x))``), which follows from the rule with no
    tolerance.  Control: the quantizer replaced by a bare cast must fail
    it.  The request is admitted by the classic ``prefill`` and decoded
    by the slot layout's one-step program, so the check holds those
    writers; the paged admission writes through the same
    ``transformer._to_cache_dtype`` (:func:`kv_store` replaces it on the
    module), and the paged int8 layout is held bitwise to the slot one by
    :func:`paged_programs`.  Reported, not gated: the share of codes at
    +-127 after the admission, and the int8 run's logits against a plain
    model-dtype cache's (largest difference, argmax agreement)."""
    import numpy as np
    import torch

    from repro_torch.models import prefill
    from repro_torch.models.transformer import cache_leaves
    from repro_torch.serve.engine import _decode_fn
    from repro_torch.serve.graphs import DecodeGraph

    t0 = time.perf_counter()
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab, (1, FIXED_PROMPT + FIXED_STEPS), dtype=np.int32),
        device="cuda")
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    plain = dataclasses.replace(cfg, kv_cache_dtype=None)

    def run(c, store=None):
        ctx = kv_store(store) if store else contextlib.nullcontext()
        with ctx:
            logits, cache = prefill(params, c, toks[:, :FIXED_PROMPT],
                                    cache_len=FIXED_PROMPT + FIXED_STEPS)
            sat = [(t.abs() == 127).float().mean().item()
                   for t in cache_leaves(cache) if t.dtype == torch.int8]
            g = DecodeGraph(_decode_fn(c), params, cache, 1, name="decode")
            out = [logits.float()]
            for i in range(FIXED_STEPS):
                pos = FIXED_PROMPT + i
                out.append(g.run(toks[0, pos:pos + 1].cpu().numpy(),
                                 [pos]).float().clone())
        assert g.info["replays"] == (FIXED_STEPS - 1 if g.capture_on
                                     else 0), g.info
        return out, sat

    got, sat = run(int8)
    fake, _ = run(plain, "fake")
    bare, _ = run(int8, "bare")
    ref, _ = run(plain)
    equal = [torch.equal(a, b) for a, b in zip(got, fake)]
    agree = sum(int(a.argmax() == b.argmax()) for a, b in zip(got, ref))
    assert all(equal), f"{label}: int8 steps not bitwise the fake-quantized"
    control = [torch.equal(a, b) for a, b in zip(bare, fake)]
    assert not all(control), f"{label}: the bare-cast control passed"
    return {"label": label, "steps": FIXED_STEPS,
            "wall_s": time.perf_counter() - t0,
            "bitwise_steps": f"{sum(equal)}/{len(equal)}",
            "control_bitwise_steps": f"{sum(control)}/{len(control)}",
            "saturated_share": sat,
            "vs_model_dtype_cache": {
                "max_abs_err": max((a - b).abs().max().item()
                                   for a, b in zip(got, ref)),
                "argmax_agree": f"{agree}/{len(got)}"}}


def shared_requests(cfg):
    """(k2)'s trace: 8 requests sharing one 64-token prefix, each with its
    own 16-40-token suffix, 32 new tokens."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(8)
    prefix = rng.integers(0, cfg.vocab, SHARED_PREFIX, dtype=np.int32)
    return [Request(uid=i, prompt=np.concatenate(
        [prefix, rng.integers(0, cfg.vocab, n, dtype=np.int32)]),
        max_new_tokens=32) for i, n in enumerate(SHARED_SUFFIXES)]


def long_requests(cfg):
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(9)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, LONG_PROMPT,
                                               dtype=np.int32),
                    max_new_tokens=32) for i in range(4)]


def long_cache_bound(cfg, weights: int) -> dict:
    """(k5)'s step byte bound: the weights one decode step reads and the
    cache rows it reads, each slot's valid rows (LONG_PROMPT to
    LONG_PROMPT + 31, 16 on average past the prompt), K and V of every
    layer in the cache dtype, at 3.35 TB/s."""
    from repro_torch.models.transformer import _cache_dt

    rows = 4 * (LONG_PROMPT + 16)
    per_row = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd \
        * _cache_dt(cfg).itemsize
    return {"weights": weights, "cache_rows": rows * per_row,
            "bound_ms": (weights + rows * per_row) / HBM_BYTES_PER_S * 1e3}


def kvcache_phase(card: str, smoke: bool = False) -> dict:
    """Phase 3k (``python3 chip_smoke.py --kvcache``): the int8 KV cache
    and paged serving at full width (qwen at full depth; ``smoke``: the SMOKE
    configs, for a rehearsal), bf16, seeded random weights.

    qwen1.5-4b, dense and n:m:g 1:4:8 gr64 ``attn=True``: (k1) the trace
    through a paged engine (pages of 16) beside the slot engine, tokens
    equal, ``paged_prefill`` 4 and ``paged_decode_chunk`` 1 built in the
    warm-up and none in the measured run; :func:`paged_programs` on the
    paged engine.  n:m:g only: (k2) :func:`shared_requests` with prefix
    sharing on, then off in the same engine, tokens equal and
    ``shared_tokens`` > 0 only with sharing; (k3) the trace with half the
    pages, every request finished with (k1)'s tokens, a deferred
    admission or a preemption; (k4) ``kv_cache_dtype="int8"`` in both
    layouts (tokens equal, :func:`paged_programs`) and
    :func:`fixed_check`; (k5) per-token p50, TTFT p50 and cache bytes of
    every engine, the replayed chunk's device span of the n:m:g slot and
    paged engines, bf16 and int8, in turns, and the long run: four
    1536-token prompts at 2048 rows, bf16 against int8 slot caches,
    beside the step's byte bound.  minicpm3-4b n:m:g at
    :data:`KV_MLA_LAYERS` layers: (k4) with its int8 latents.  Each
    engine run's
    launch counts are returned under ``counts`` (the n:m:g ones feed the
    ``kernels`` line)."""
    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import init_lm
    from repro_torch.serve import sparsify_for_serving

    get, gr = (get_smoke, 16) if smoke else (get_config, 64)
    res: dict = {"runs": {}, "programs": [], "fixed": [], "init_s": {}}
    runs = res["runs"]

    def serve(cfg, params, label, reqs=None, built=None, **kw):
        runs[label], eng = kv_serve(cfg, params, label,
                                    reqs or requests_for(cfg), built, **kw)
        return runs[label], eng

    paged = dict(paged=True, page_size=PAGE_SIZE)
    slot_built = {"slot_prefill": len(PROMPT_LENS), "decode_chunk": 1}
    paged_built = {"paged_prefill": len(PROMPT_LENS),
                   "paged_decode_chunk": 1}
    for arch, short in (("qwen1.5-4b", "qwen"), ("minicpm3-4b", "minicpm3")):
        cfg = get(arch)
        if short == "minicpm3" and not smoke:
            cfg = dataclasses.replace(cfg, n_layers=KV_MLA_LAYERS)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = init_lm(cfg, seed=0, device="cuda")
        sparse = sparsify_for_serving(params, 1, 4, 8, gr=gr, attn=True)
        torch.cuda.synchronize()
        res["init_s"][short] = time.perf_counter() - t0
        engines = {}
        if short == "qwen":
            # (k1) paged against slot, dense and n:m:g
            for kind, p in (("dense", params), ("sparse", sparse)):
                lab = f"qwen_{kind}"
                s, es = serve(cfg, p, f"{lab}_slot", built=slot_built)
                g, eg = serve(cfg, p, f"{lab}_paged", built=paged_built,
                              **paged)
                assert g["tokens"] == s["tokens"], f"{lab}: paged tokens"
                assert g["counts"] == s["counts"], (lab, g["counts"],
                                                    s["counts"])
                res["programs"].append(paged_programs(cfg, p, lab, eg))
                if kind == "sparse":   # spans in turns with the int8 ones
                    engines = {f"{lab}_slot": es, f"{lab}_paged": eg}
                del es, eg
        del params
        torch.cuda.empty_cache()
        if short == "qwen":
            # (k2) prefix sharing, on, then off in the same engine (its
            # programs built, none built again)
            on, eng = serve(cfg, sparse, "qwen_shared",
                            shared_requests(cfg), max_seq_len=144, **paged)
            eng.kv.prefix_sharing = False
            off, _ = serve(cfg, sparse, "qwen_unshared",
                           shared_requests(cfg), built={}, eng=eng)
            del eng
            assert on["tokens"] == off["tokens"], "prefix sharing tokens"
            assert off["kv_stats"]["shared_tokens"] == 0, off["kv_stats"]
            assert on["kv_stats"]["shared_tokens"] > 0, on["kv_stats"]
            # (k3) half the default pages
            half = ENGINE_KW["max_slots"] * ENGINE_KW["max_seq_len"] \
                // PAGE_SIZE // 2
            pr, _ = serve(cfg, sparse, "qwen_pressure", num_pages=half,
                          **paged)
            assert pr["tokens"] == runs["qwen_sparse_slot"]["tokens"]
            assert pr["stats"]["deferred_admissions"] \
                + pr["stats"]["preemptions"] > 0, pr["stats"]
        # (k4) int8 latents / K/V, slot and paged, and the fixed check
        c8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
        s8, engines[f"{short}_int8_slot"] = serve(
            c8, sparse, f"{short}_int8_slot", built=slot_built)
        p8, engines[f"{short}_int8_paged"] = serve(
            c8, sparse, f"{short}_int8_paged", built=paged_built, **paged)
        assert p8["tokens"] == s8["tokens"], f"{short}: int8 paged tokens"
        span_turns(runs, engines)
        res["programs"].append(paged_programs(
            c8, sparse, f"{short}_int8", engines[f"{short}_int8_paged"]))
        del engines
        res["fixed"].append(fixed_check(cfg, sparse, short))
        if short == "qwen":
            # (k5) the long run, bf16 against int8 slot caches
            weights = step_weight_bytes(sparse)
            engines = {}
            for c, lab in ((cfg, "qwen_long_bf16"), (c8, "qwen_long_int8")):
                r, engines[lab] = serve(c, sparse, lab, long_requests(cfg),
                                        max_slots=4, max_seq_len=LONG_SEQ)
                r["bound"] = long_cache_bound(c, weights)
            span_turns(runs, engines)
            del engines
        del sparse
    res["peak_gb"] = _gb_peak()
    res["counts"] = {lab: r["counts"] for lab, r in runs.items()
                     if not lab.startswith("qwen_dense")}
    report_kvcache(res, card)
    return res


def report_kvcache(res, card) -> None:
    runs = res["runs"]
    for lab, r in runs.items():
        m = r["metrics"]
        extra = ""
        if "kv_stats" in r:
            kv = r["kv_stats"]
            extra = (f"; {r['num_pages']} pages, peak "
                     f"{kv['peak_pages_in_use']}, {kv['shared_tokens']} "
                     f"prompt tokens shared, "
                     f"{kv['cow_copies']} copy-on-write copies, deferred "
                     f"admissions {r['stats']['deferred_admissions']}, "
                     f"preemptions {r['stats']['preemptions']}")
        if "bound" in r:
            b = r["bound"]
            extra += (f"; step byte bound {b['bound_ms']:.3f} ms (weights "
                      f"{b['weights'] / 1e9:.3f} GB + cache rows "
                      f"{b['cache_rows'] / 1e9:.3f} GB)")
        span = (f"chunk span {r['chunk_span_ms']:.3f} ms (in turns: "
                f"{', '.join(f'{v:.3f}' for v in r['chunk_spans_ms'])}); "
                if "chunk_span_ms" in r else "")
        print(f"kvcache[{lab}] on {card}: per-token p50 "
              f"{m['tok_latency_p50'] * 1e3:.3f} ms, TTFT p50 "
              f"{m['ttft_p50'] * 1e3:.3f} ms (replayed); {span}cache "
              f"{r['cache_bytes'] / 2**20:.1f} MiB{extra}", flush=True)
    for p in res["programs"]:
        print(f"kvcache programs[{p['label']}] on {card}: bitwise "
              f"({p['bitwise']})", flush=True)
    for f in res["fixed"]:
        print(f"kvcache fixed check[{f['label']}] on {card}: int8 steps "
              f"bitwise the fake-quantized model-dtype cache's "
              f"{f['bitwise_steps']}; control (bare cast) "
              f"{f['control_bitwise_steps']} (fails as it must); codes at "
              f"+-127 after admission {f['saturated_share']}; against a "
              f"model-dtype cache: logits max abs "
              f"{f['vs_model_dtype_cache']['max_abs_err']:.4f}, argmax "
              f"{f['vs_model_dtype_cache']['argmax_agree']}", flush=True)
    walls = [f"init {', '.join(f'{k} {v:.1f}' for k, v in res['init_s'].items())}"]
    walls += [f"{lab} {r['wall_s']:.1f} (warm-up {r['warm_s']:.1f})"
              for lab, r in runs.items()]
    walls += [f"programs[{p['label']}] {p['wall_s']:.1f}"
              for p in res["programs"]]
    walls += [f"fixed[{f['label']}] {f['wall_s']:.1f}" for f in res["fixed"]]
    print(f"kvcache seconds on {card}: {'; '.join(walls)}", flush=True)


# ---------------------------------------------------------------------------
# phase 3l: SLO-controlled serving with resident sparsity tiers (qwen1.5-4b)
# ---------------------------------------------------------------------------

#: the tiers phase (l) serves, densest first
SLO_TIERS = ("dense", "2:4", "1:4:8-gr64")
#: the SLO: healthy dense qwen reads ~10.4 ms a step at 4 slots (PERF.md),
#: inside the hold band 8.4-12.6 ms of 14 ms; the x3 slow window is hot
SLO_TPOT_MS = 14.0
#: the bursty trace: a steady stream with one thundering herd, 40 requests
SLO_ARRIVALS = dict(n_background=24, rate_hz=6.0, bursts=((1.0, 16),),
                    seed=0)
#: the fault storm of (l1) and (l3)
SLO_FAULTS = dict(seed=0, spike_prob=0.02, error_prob=0.02,
                  slow_windows=((8, 24, 3.0),))
SLO_ENGINE_KW = dict(ENGINE_KW, decode_chunk=8)


def slo_requests(cfg, arrivals=None, n: int = 0) -> list:
    """Prompts cycling (32, 24, 64, 16), 32 new tokens each, greedy; at
    ``arrivals`` (seconds) when given, else ``n`` all due at once."""
    import numpy as np

    from repro_torch.serve import Request

    times = list(arrivals) if arrivals is not None else [0.0] * n
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, PROMPT_LENS[i % 4], dtype=np.int32), max_new_tokens=32,
        arrival_time=float(t)) for i, t in enumerate(times)]


def serve_paced(eng, requests) -> list:
    """Drive ``eng`` as an endpoint's clients do: each request is
    submitted when its arrival time has come, so the engine's queue (and
    the depth its SLO controller reads) holds only work that has arrived;
    ``run(due, max_steps=1)`` submits it and takes one scheduler step;
    while nothing is due or in flight, sleep towards the next arrival.
    ``run([], max_steps=0)`` first starts the engine's clock with this
    loop's.  Returns every output, in uid order."""
    import collections

    pending = collections.deque(sorted(requests,
                                       key=lambda r: r.arrival_time))
    t0 = time.perf_counter()
    eng.run([], max_steps=0)
    outs = []
    while pending or eng.num_active or len(eng.queue):
        now = time.perf_counter() - t0
        due = []
        while pending and pending[0].arrival_time <= now:
            due.append(pending.popleft())
        if not due and not eng.num_active and not len(eng.queue):
            time.sleep(min(0.05, max(0.0, pending[0].arrival_time - now)))
            continue
        outs += eng.run(due, max_steps=1)
    return sorted(outs, key=lambda o: o.uid)


def _pool_mib_by_tier(eng) -> dict:
    """Graph-pool MiB each tier's captures added (decode programs and
    admissions)."""
    out = {}
    for t, tier in enumerate(eng.tiers):
        progs = [g for (i, _), g in eng._programs.items() if i == t]
        progs += [g for (i, _), g in eng.kv.programs.items() if i == t]
        out[tier.spec.name] = sum(g.info.get("pool_bytes", 0)
                                  for g in progs) / 2**20
    return out


def slo_cli_phase() -> dict:
    """(l5) The CLIs at bert-base-sten's full width, each in a subprocess
    that must exit 0: the SLO engine with tiers, faults and a trace (which
    must validate, and ``python -m repro_torch.obs validate`` exit 0 on
    it), the one-shot ``--batch 4`` mode, and the trainer with a trace
    (which must hold ``train_chunk`` spans and ``sparsity`` events).  The
    three CLIs start together (they are checks, not timings: each one's
    ``wall_s`` runs from the common start to when it is collected, in
    the order above, no earlier than its exit); the validator runs on
    the serve trace once it is written."""
    import os
    import tempfile

    from repro_torch.obs.export import load_trace, validate_chrome_trace

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = {}
    with tempfile.TemporaryDirectory() as d:
        serve_trace, train_trace = f"{d}/serve.json", f"{d}/train.json"
        waves = (
            {"serve_slo": ["repro_torch.launch.serve", "--engine", "--tiers",
                           "dense,1:4:8-gr64", "--slo-tpot-ms", "50",
                           "--faults", "--trace", serve_trace],
             "serve_oneshot": ["repro_torch.launch.serve", "--batch", "4"],
             "train_trace": ["repro_torch.launch.train", "--steps", "4",
                             "--sparsity", "0.75", "--gmp", "iterative",
                             "--trace", train_trace]},
            {"obs_validate": ["repro_torch.obs", "validate", serve_trace]},
        )
        for runs in waves:
            t0 = time.perf_counter()
            procs = {}
            try:
                for name, argv in runs.items():
                    logs = (open(f"{d}/{name}.out", "w+"),
                            open(f"{d}/{name}.err", "w+"))
                    procs[name] = (subprocess.Popen(
                        [sys.executable, "-m", *argv], stdout=logs[0],
                        stderr=logs[1], text=True, cwd=ROOT, env=env),
                        logs, argv)
                for name, (p, logs, argv) in procs.items():
                    rc = p.wait(timeout=max(1.0, 300 - (time.perf_counter()
                                                        - t0)))
                    for f in logs:
                        f.seek(0)
                    out, err = (f.read() for f in logs)
                    if rc:
                        raise RuntimeError(f"{' '.join(argv)} exited {rc}:"
                                           f"\n{out}\n{err}")
                    res[name] = {"wall_s": time.perf_counter() - t0,
                                 "tail": out.strip().splitlines()[-3:]}
            finally:
                for p, logs, _ in procs.values():
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                    for f in logs:
                        f.close()
        doc = load_trace(serve_trace)
        assert validate_chrome_trace(doc) == [], "serve trace invalid"
        tdoc = load_trace(train_trace)
        assert validate_chrome_trace(tdoc) == [], "train trace invalid"
        names = [e["name"] for e in tdoc["traceEvents"]]
    res["train_chunks"] = names.count("train_chunk")
    res["train_sparsity_events"] = names.count("sparsity")
    assert res["train_chunks"] > 0 and res["train_sparsity_events"] > 0, res
    return res


def slo_phase(card: str) -> dict:
    """Phase 3l (``python3 chip_smoke.py --slo``): qwen1.5-4b at full
    width and depth (40 layers), bf16, seeded random weights, served
    through the SLO engine with the tiers ``dense,2:4,1:4:8-gr64``
    resident (4 slots of 96 rows, chunk 8, shrunk to 4), every tier's
    decode programs (8, 4, 1 steps) and admissions (16, 24, 32, 64
    tokens) captured by ``warm_tiers`` before the trace.

    (l1) The bursty trace (:data:`SLO_ARRIVALS`: 24 requests at 6/s and
    16 at once at 1 s), each request submitted as it arrives
    (:func:`serve_paced`), under :data:`SLO_FAULTS` with the flight
    recorder on: every request terminal, a tier switch and tokens from two tiers,
    fault retries, no program built, the sparse tiers' kernels launched
    (no fused QKV: the tiers convert the FFN only), the Chrome trace valid
    with a ``prefill`` span for every admitted request.  (l2) An engine on
    the same tiers without a controller: batches under ``set_tier(0)``,
    ``(2)``, ``(1)``, each bitwise a plain engine on that tier's params
    alone; the control (tier 2 against the dense engine) differs.  (l3)
    The storm at the fixed ``1:4:8-gr64`` tier on the paged engine: every
    request terminal, survivors bitwise the fault-free run, no page in
    use after.  (l4) (l2)'s tier-0 batch with the recorder on: tokens
    and launch counts those of the run without it.  (l5)
    :func:`slo_cli_phase`."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.obs import trace as obs
    from repro_torch.obs.__main__ import main as obs_main
    from repro_torch.obs.export import load_trace, validate_chrome_trace
    from repro_torch.obs.registry import REGISTRY
    from repro_torch.serve import FaultConfig, FaultInjector, SLOConfig, \
        ServeEngine, burst_arrivals, warmup_engine
    from repro_torch.serve.tracecount import trace_events

    t_phase = time.perf_counter()
    REGISTRY.reset()           # the trace's snapshot holds this phase alone
    cfg = get_config("qwen1.5-4b")
    res: dict = {"layers": cfg.n_layers}
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    reset_counts()             # what the tiers' conversion launches
    eng = ServeEngine(params, cfg, tiers=SLO_TIERS,
                      slo=SLOConfig(tpot_ms=SLO_TPOT_MS),
                      faults=FaultInjector(FaultConfig(**SLO_FAULTS)),
                      **SLO_ENGINE_KW)
    torch.cuda.synchronize()
    res["convert_counts"] = read_counts()
    res["init_convert_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.warm_tiers(PROMPT_LENS)
    res["warm_s"] = time.perf_counter() - t0
    res["pool_mib"] = _pool_mib_by_tier(eng)
    res["chunk_sizes"] = eng._chunk_sizes
    built = dict(trace_events())
    assert built == {"slot_prefill": 4 * 3, "decode": 3,
                     "decode_chunk": 6}, built
    assert all(g.info["captured"] for g in list(eng._programs.values())
               + list(eng.kv.programs.values()))

    # (l1) the bursty trace, faults injected, the recorder on
    reqs = slo_requests(cfg, burst_arrivals(**SLO_ARRIVALS))
    assert len(reqs) == 40
    obs.enable()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = serve_paced(eng, reqs)
    torch.cuda.synchronize()
    res["l1_wall_s"] = time.perf_counter() - t0
    counts = read_counts()
    obs.disable()
    assert trace_events() == built, ("built after warm_tiers",
                                     trace_events())
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    trace_path = out / "chip_smoke_slo_trace.json"
    obs.dump(str(trace_path), registry_snapshot=REGISTRY.snapshot())
    doc = load_trace(str(trace_path))
    problems = validate_chrome_trace(doc)
    assert problems == [], problems[:5]
    assert obs_main(["validate", str(trace_path)]) == 0
    served = {o.uid for o in outs if o.finish_reason in ("length", "stop")}
    prefilled = {e["args"]["uid"] for e in doc["traceEvents"]
                 if e["name"] == "prefill"}
    assert served <= prefilled, sorted(served - prefilled)
    terminal = ("length", "stop", "rejected", "timeout", "shed")
    assert len(outs) == 40 and all(o.finish_reason in terminal
                                   for o in outs), [o.finish_reason
                                                    for o in outs]
    for o in outs:
        if o.uid in served:
            assert len(o.tokens) == 32 and all(0 <= t < cfg.vocab
                                               for t in o.tokens)
    st = dict(eng.stats)
    by_tier = dict(eng.tokens_by_tier)
    assert st["tier_switches"] >= 1, st
    assert sum(v > 0 for v in by_tier.values()) >= 2, by_tier
    assert st["fault_retries"] > 0, st
    for k in ("nmg_ffn", "nmg_gemv", "nmg_spmm"):
        assert counts[k] > 0, (k, counts)
    assert counts["nmg_qkv"] == 0, counts
    assert not any(k.endswith("/plain") for k in counts["routes"]), counts
    met = eng.metrics(label="slo").to_dict()
    res.update(l1={
        "metrics": met, "stats": st, "tokens_by_tier": by_tier,
        "counts": counts, "faults": dict(eng.faults.injected),
        "slo_counters": dict(eng._controller.counters),
        "final_level": eng._controller.level,
        "tpot_model_s": eng._latency.tpot_s(),
        "served": len(served), "trace_events": len(doc["traceEvents"]),
        "dropped": doc["metadata"]["dropped_records"],
        "outcomes": {r: sum(o.finish_reason == r for o in outs)
                     for r in terminal}})
    tiers = eng.tiers
    del eng, outs
    gc.collect()
    torch.cuda.empty_cache()

    # (l2) the same tiers, no controller: a manual tier holds
    t0 = time.perf_counter()
    batch = {0: slo_requests(cfg, n=4)}
    for t in (1, 2):
        batch[t] = [dataclasses.replace(r, uid=r.uid + 4 * t)
                    for r in batch[0]]
    teng = ServeEngine(params, cfg, tiers=tiers, **SLO_ENGINE_KW)
    teng.warm_tiers(PROMPT_LENS)
    tbuilt = dict(trace_events())
    got, got_counts = {}, {}
    for t in (0, 2, 1):
        teng.set_tier(t)
        torch.cuda.synchronize()
        reset_counts()
        got[t] = [o.tokens for o in teng.run(batch[t])]
        torch.cuda.synchronize()
        got_counts[t] = read_counts()
    assert trace_events() == tbuilt, "built after warm_tiers (l2)"
    plain = {}
    for t in (0, 2, 1):
        ref = ServeEngine(tiers[t].params, cfg, **SLO_ENGINE_KW)
        warmup_engine(ref, batch[t])
        plain[t] = [o.tokens for o in ref.run(batch[t])]
        del ref
        assert got[t] == plain[t], f"tier {t} differs from its own engine"
    control = got[2] != plain[0]
    assert control, "control: tier 2 equals the dense engine's tokens"
    for t in (1, 2):
        assert got_counts[t]["nmg_ffn"] > 0 and got_counts[t]["nmg_qkv"] \
            == 0, got_counts[t]

    # (l4) the recorder changes nothing: (l2)'s tier-0 batch again
    teng.set_tier(0)
    obs.enable()
    torch.cuda.synchronize()
    reset_counts()
    again = [o.tokens for o in teng.run(
        [dataclasses.replace(r, uid=r.uid + 100) for r in batch[0]])]
    torch.cuda.synchronize()
    again_counts = read_counts()
    obs.disable()
    obs.clear()
    assert again == got[0], "tokens moved with the recorder on"
    assert again_counts == got_counts[0], (again_counts, got_counts[0])
    res["l2"] = {"bitwise": True, "control_differs": control,
                 "counts": {t: got_counts[t] for t in got_counts},
                 "wall_s": time.perf_counter() - t0}
    res["l4"] = {"bitwise": True, "counts_equal": True}
    del teng
    gc.collect()
    torch.cuda.empty_cache()

    # (l3) the storm at the fixed 1:4:8-gr64 tier on the paged engine
    t0 = time.perf_counter()
    sparse = tiers[2].params
    peng = ServeEngine(sparse, cfg, paged=True, page_size=PAGE_SIZE,
                       **SLO_ENGINE_KW)
    warmup_engine(peng, reqs)
    base = {o.uid: o.tokens for o in serve_paced(peng, reqs)
            if o.finish_reason in ("length", "stop")}
    assert len(base) == 40 and peng.kv.alloc.pages_in_use() == 0
    peng.reset_metrics()
    peng.faults = FaultInjector(FaultConfig(**SLO_FAULTS))
    pbuilt = dict(trace_events())
    storm = serve_paced(peng, reqs)
    assert trace_events() == pbuilt, "built in the storm"
    assert all(o.finish_reason in terminal for o in storm)
    survivors = {o.uid: o.tokens for o in storm
                 if o.finish_reason in ("length", "stop")}
    for uid, toks in survivors.items():
        assert toks == base[uid], f"uid {uid} diverged under the storm"
    assert peng.kv.alloc.pages_in_use() == 0, "pages left in use"
    res["l3"] = {"survivors": len(survivors), "stats": dict(peng.stats),
                 "faults": dict(peng.faults.injected),
                 "wall_s": time.perf_counter() - t0}
    del peng, params, sparse, tiers
    gc.collect()
    torch.cuda.empty_cache()

    # (l5) the CLIs at bert-base-sten's full width
    res["l5"] = slo_cli_phase()
    res["phase_s"] = time.perf_counter() - t_phase
    report_slo(res, card)
    return res


def report_slo(res, card) -> None:
    l1, m = res["l1"], res["l1"]["metrics"]
    st = l1["stats"]
    print(f"slo[qwen1.5-4b, {res['layers']} layers, tiers "
          f"{','.join(SLO_TIERS)}] on {card}: per-token p50/p99 "
          f"{m['tok_latency_p50'] * 1e3:.3f}/{m['tok_latency_p99'] * 1e3:.3f}"
          f" ms, TTFT p50/p99 {m['ttft_p50'] * 1e3:.1f}/"
          f"{m['ttft_p99'] * 1e3:.1f} ms, SLO attainment "
          f"{m['slo_attainment']:.3f} (tpot {SLO_TPOT_MS} ms); tokens by "
          f"tier {l1['tokens_by_tier']}; shed {st['shed']}, timeout "
          f"{st['timeout']}, deferred {st['deferred_admissions']}, fault "
          f"retries {st['fault_retries']}, tier switches "
          f"{st['tier_switches']}; outcomes {l1['outcomes']}; controller "
          f"{l1['slo_counters']}, final level {l1['final_level']}; faults "
          f"{l1['faults']}", flush=True)
    print(f"slo warm_tiers on {card}: {res['warm_s']:.1f} s capturing "
          f"{len(SLO_TIERS)} tiers x (decode {res['chunk_sizes']} steps + "
          f"4 admissions); graph pool MiB by tier "
          + ", ".join(f"{k} {v:.1f}" for k, v in res["pool_mib"].items())
          + f"; init + conversion {res['init_convert_s']:.1f} s (its "
          f"nm_mask launches {res['convert_counts']['nm_mask']})", flush=True)
    print(f"slo LatencyModel.tpot_s() at the end "
          f"{l1['tpot_model_s'] * 1e3:.3f} ms beside measured per-token p50 "
          f"{m['tok_latency_p50'] * 1e3:.3f} ms; launches {l1['counts']}; "
          f"trace {l1['trace_events']} events, dropped {l1['dropped']}",
          flush=True)
    print(f"slo (l2) tiers bitwise their own engines ({res['l2']['bitwise']}"
          f"), control differs ({res['l2']['control_differs']}); (l3) "
          f"paged storm at 1:4:8-gr64: {res['l3']['survivors']} survivors "
          f"bitwise, stats {res['l3']['stats']}, faults "
          f"{res['l3']['faults']}; (l4) recorder on: tokens and counts "
          f"equal; (l5) CLIs "
          + ", ".join(f"{k} {v['wall_s']:.1f} s" for k, v in res["l5"].items()
                      if isinstance(v, dict))
          + f", train trace {res['l5']['train_chunks']} chunks "
          f"{res['l5']['train_sparsity_events']} sparsity events", flush=True)
    print(f"slo seconds on {card}: phase {res['phase_s']:.1f} (warm "
          f"{res['warm_s']:.1f}, (l1) {res['l1_wall_s']:.1f}, (l2)+(l4) "
          f"{res['l2']['wall_s']:.1f}, (l3) {res['l3']['wall_s']:.1f})",
          flush=True)


# ---------------------------------------------------------------------------
# phase 3m: the static checker (repro_torch.check)
# ---------------------------------------------------------------------------

#: (m2)'s tuned entry: qwen1.5-4b's attn.wq shape [K, R] under a table's
#: decode config, at the serve phases' decode width
CHECK_TUNED = ((2560, 2560), {"rows": 32, "parts": 4}, 4)
#: (m5)'s request spacing, seconds
CHECK_ARRIVAL_GAP = 0.02


def device_limits() -> dict:
    """The card's shared memory a block (opt-in) and an SM, and registers
    an SM, from torch's device properties or, where this torch lacks a
    field, from the CUDA runtime's ``cudaDeviceGetAttribute``."""
    import torch

    props = torch.cuda.get_device_properties(0)
    fields = {"smem_per_block_bytes": ("shared_memory_per_block_optin", 97),
              "smem_per_sm_bytes": ("shared_memory_per_multiprocessor", 81),
              "regs_per_sm": ("regs_per_multiprocessor", 82)}
    out, cudart = {}, None
    for key, (attr, code) in fields.items():
        v = getattr(props, attr, None)
        if v is None:
            if cudart is None:
                cudart = ctypes.CDLL("/usr/local/cuda/lib64/libcudart.so")
            got = ctypes.c_int()
            err = cudart.cudaDeviceGetAttribute(ctypes.byref(got), code, 0)
            assert err == 0, f"cudaDeviceGetAttribute({code}) failed: {err}"
            v = got.value
        out[key] = int(v)
    return out


def _start_cli(name: str, argv: list, d: str):
    env = {**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}
    logs = (open(f"{d}/{name}.out", "w+"), open(f"{d}/{name}.err", "w+"))
    return subprocess.Popen([sys.executable, "-m", *argv], stdout=logs[0],
                            stderr=logs[1], text=True, cwd=ROOT,
                            env=env), logs, argv


def _finish_cli(job, timeout: float) -> str:
    proc, logs, argv = job
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for f in logs:
        f.seek(0)
    out, err = (f.read() for f in logs)
    for f in logs:
        f.close()
    if rc:
        raise RuntimeError(f"{' '.join(argv)} exited {rc}:\n{out}\n{err}")
    return out


def shed_before_arrival(doc) -> int:
    """Requests of a serve trace shed before they arrived: a ``shed``
    event earlier than the start (the arrival) of its request's
    ``queued`` span."""
    arrived = {e["args"]["uid"]: e["ts"] for e in doc["traceEvents"]
               if e["name"] == "queued" and e.get("args", {}).get(
                   "outcome") == "shed"}
    return sum(1 for e in doc["traceEvents"]
               if e["name"] == "shed" and e["ts"] < arrived[e["args"]["uid"]])


@contextlib.contextmanager
def entries_replaced(programs):
    """The checker's entries replaced by ``programs`` (a control for
    ``preflight``)."""
    from repro_torch.check import entries

    saved = entries.entry_programs
    entries.entry_programs = lambda *a, **k: list(programs)
    try:
        yield
    finally:
        entries.entry_programs = saved


def check_phase(card: str, tpot_ms: float) -> dict:
    """Phase 3m (``python3 chip_smoke.py --check <tpot ms>``): the static
    checker on the card.  (m5)'s two CLIs start first, in processes of
    their own, and are read last.

    (m1) ``launch/hw.py``'s entry for this card equal to its properties,
    R7 silent; (m2) a tuned ``gemv_cuda`` entry's R6 estimate equal to
    the library's figure (every kernel-phase case was held in the main
    process), its launch against the plain version; (m3) qwen1.5-4b at
    full width and 4 layers, ``attn=True`` 1:4:8 gr64, bf16: every serve
    program traced and captured, no ERROR with R3 ignored (bf16 norms run
    in f32, the reason the check configs pin f32); (m4) the differential
    at the check config: no ``DIFF``, the GEMV and the SpMM launched;
    (m5) ``serve --engine --check --arrival-gap 0.02 --slo-tpot-ms
    <tpot_ms>`` and ``train --check --steps 2`` at bert-base-sten's width
    exit 0 with clean preflights, and the serve trace sheds no request
    before it arrives; (m6) every trigger fixture on the card yields its
    rule (R4's also at its failed capture), every clean one none, and
    ``preflight`` returns 1 on the R1 trigger."""
    import collections
    import tempfile

    import torch

    from repro_torch.check import Report, preflight
    from repro_torch.check.differential import differential_check
    from repro_torch.check.entries import entry_programs
    from repro_torch.check.fixtures import FIXTURES
    from repro_torch.check.rules import run_rules
    from repro_torch.check.static_pass import gemv_smem
    from repro_torch.configs import get_config
    from repro_torch.core.nmg import dense_to_grouped_nm
    from repro_torch.kernels import nmg_gemv
    from repro_torch.launch.hw import hw_for_device
    from repro_torch.obs.export import load_trace, validate_chrome_trace
    from repro_torch.tune.routing import clear_active_table, \
        set_active_table
    from repro_torch.tune.table import TuningTable, device_kind

    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as d:
        trace = f"{d}/serve_trace.json"
        jobs = {
            "serve": _start_cli("serve", [
                "repro_torch.launch.serve", "--arch", "bert-base-sten",
                "--engine", "--check", "--arrival-gap",
                str(CHECK_ARRIVAL_GAP), "--slo-tpot-ms", f"{tpot_ms:.4f}",
                "--requests", "8", "--gen-len", "8", "--trace", trace], d),
            "train": _start_cli("train", [
                "repro_torch.launch.train", "--arch", "bert-base-sten",
                "--check", "--steps", "2"], d)}
        try:
            # (m1) the device model
            t0 = time.perf_counter()
            kind = device_kind()
            hw, matched = hw_for_device(kind)
            limits = device_limits()
            assert matched, f"no HW_BY_KIND entry for {kind}"
            assert all(hw[k] == v for k, v in limits.items()), (hw, limits)
            r7 = run_rules(FIXTURES["R7"]["clean"]("cuda"))
            assert not [x for x in r7 if x.rule == "R7"], r7
            res["m1"] = {"kind": kind, "limits": limits,
                         "hw": {k: hw[k] for k in limits},
                         "wall_s": time.perf_counter() - t0}

            # (m2) a tuned entry, estimate against the library
            t0 = time.perf_counter()
            (K, R), cfg, M = CHECK_TUNED
            bf16 = torch.bfloat16
            gen = torch.Generator(device="cuda").manual_seed(31)
            w = dense_to_grouped_nm(
                (torch.randn(K, R, generator=gen, device="cuda")
                 / math.sqrt(K)).to(bf16), 1, 4, 8, gr=64, sparse_dim=0)
            x = torch.randn(M, K, generator=gen, device="cuda").to(bf16)
            set_active_table(TuningTable(device=kind,
                                         entries={"gemv_cuda": dict(cfg)}))
            try:
                est = gemv_smem(w, bf16, M, kind)
                assert est["source"] == "table" and est["config"] == cfg
                tuned = rows_resources("nmg_gemv", w, x.T, config=cfg)
                got = nmg_gemv.nmg_gemv(w, x.T, transpose_out=True,
                                        config=cfg)
            finally:
                clear_active_table()
            ref = nmg_gemv.nmg_gemv_plain(w, x.T, transpose_out=True)
            err = (got - ref).abs().max().item()
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            assert err <= tol, ("tuned gemv", err, tol)
            res["m2"] = {"tuned": {"K": K, "R": R, "M": M, "config": cfg,
                                   "estimate_bytes": est["dynamic_bytes"],
                                   "library_bytes": tuned["smem_bytes"]
                                   - est["static_bytes"],
                                   "registers": tuned["registers"],
                                   "max_abs_err": err, "tol": tol},
                         "held": len(R6_HELD),
                         "wall_s": time.perf_counter() - t0}
            del w, x, got, ref

            # (m3) qwen1.5-4b at full width, 4 layers, attn=True, captured
            t0 = time.perf_counter()
            depth = PHASE_DEPTH["check/qwen1.5-4b"]
            qcfg = get_config("qwen1.5-4b").scaled(n_layers=depth)
            progs = entry_programs("serve", arch="qwen1.5-4b", hlo=True,
                                   device="cuda", cfg=qcfg, attn=True)
            diags = [x for prog in progs for x in run_rules(prog)]
            report = Report(diags).filtered(("R3",))
            assert not report.errors, report.render()
            for prog in progs:
                assert prog.capture["captured"], (prog.name, prog.capture)
            res["m3"] = {
                "programs": [prog.name for prog in progs],
                "layers": depth, "of_layers": get_config(
                    "qwen1.5-4b").n_layers,
                "diagnostics_per_rule": dict(collections.Counter(
                    x.rule for x in diags)),
                "after_ignore_R3": dict(collections.Counter(
                    x.rule for x in report.diagnostics)),
                "nodes": {prog.name: len(prog.graph.nodes)
                          for prog in progs},
                "kernel_nodes": {prog.name: dict(collections.Counter(
                    n.op for n in prog.graph.kernels())) for prog in progs},
                "smem_max_bytes": max(e["bytes"] for prog in progs
                                      for e in prog.smem_estimates),
                "estimates": sum(len(prog.smem_estimates) for prog in progs),
                "wall_s": time.perf_counter() - t0}
            del progs, diags
            torch.cuda.empty_cache()

            # (m4) the differential at the check config
            t0 = time.perf_counter()
            ddiags, detail = differential_check(device="cuda")
            assert not ddiags, "\n".join(x.render() for x in ddiags)
            assert detail["launches"].get("nmg_gemv", 0) > 0 and \
                detail["launches"].get("nmg_spmm", 0) > 0, detail
            res["m4"] = {**detail, "wall_s": time.perf_counter() - t0}

            # (m6) the controls
            t0 = time.perf_counter()
            controls = {}
            for rid in sorted(FIXTURES):
                trig = FIXTURES[rid]["trigger"]("cuda")
                clean = FIXTURES[rid]["clean"]("cuda")
                hits = [x for x in run_rules(trig) if x.rule == rid]
                assert hits, f"{rid} trigger yields no {rid} on the card"
                assert not [x for x in run_rules(clean) if x.rule == rid], \
                    f"{rid} clean fixture trips {rid} on the card"
                controls[rid] = {"severities": sorted({
                    x.severity.name for x in hits}),
                    "locations": sorted({x.location for x in hits})}
                if rid == "R4":
                    assert trig.capture["op"] == \
                        "aten._local_scalar_dense", trig.capture
                    assert "capture" in controls[rid]["locations"]
                    assert clean.capture["captured"], clean.capture
                    controls[rid]["capture"] = trig.capture
                if rid == "R1":
                    with entries_replaced([trig]):
                        rc = preflight(("serve",), device="cuda")
                    assert rc == 1, rc
                    controls[rid]["preflight_rc"] = rc
            res["m6"] = {"controls": controls,
                         "wall_s": time.perf_counter() - t0}

            # (m5) the CLIs
            t0 = time.perf_counter()
            outs = {name: _finish_cli(job, 240) for name, job in
                    jobs.items()}
            for name, out in outs.items():
                assert "0 error(s)" in out, (name, out)
            doc = load_trace(trace)
            assert validate_chrome_trace(doc) == [], "serve trace invalid"
            early = shed_before_arrival(doc)
            assert early == 0, f"{early} requests shed before arrival"
            res["m5"] = {"tpot_ms": tpot_ms,
                         "arrival_gap_s": CHECK_ARRIVAL_GAP,
                         "shed_before_arrival": early,
                         "shed": sum(e["name"] == "shed"
                                     for e in doc["traceEvents"]),
                         "tails": {k: v.strip().splitlines()[-3:]
                                   for k, v in outs.items()},
                         "wait_s": time.perf_counter() - t0}
        finally:
            for proc, logs, _ in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                for f in logs:
                    f.close()
    res["wall_s"] = time.perf_counter() - t_phase
    return res


def report_check(res, card) -> None:
    m1, m2, m3, m4, m5 = (res[k] for k in ("m1", "m2", "m3", "m4", "m5"))
    print(f"check (m1) on {card}: {m1['kind']} limits {m1['limits']} equal "
          f"to launch/hw.py; R7 silent")
    t = m2["tuned"]
    print(f"check (m2): R6 estimate equal to the library's figure in "
          f"{res['held_main']} kernel-phase cases; tuned gemv_cuda "
          f"{t['config']} at K={t['K']} M={t['M']}: {t['estimate_bytes']} B "
          f"(library {t['library_bytes']} B), launch err "
          f"{t['max_abs_err']:.2e}")
    print(f"check (m3): qwen1.5-4b {m3['layers']} of {m3['of_layers']} "
          f"layers, attn=True, bf16: {len(m3['programs'])} programs traced "
          f"and captured in {m3['wall_s']:.1f} s; diagnostics per rule "
          f"{m3['diagnostics_per_rule']} (R3 ignored), largest block "
          f"{m3['smem_max_bytes']} B of {m3['estimates']} estimates")
    print(f"check (m4): differential agrees ({len(m4['observed'])} keys), "
          f"launches {m4['launches']} in {m4['wall_s']:.1f} s")
    print(f"check (m5): serve --check --arrival-gap {m5['arrival_gap_s']} "
          f"--slo-tpot-ms {m5['tpot_ms']:.3f} and train --check exit 0; "
          f"shed {m5['shed']}, before arrival {m5['shed_before_arrival']}")
    print(f"check (m6): every trigger fires on the card "
          f"{ {k: v['locations'] for k, v in res['m6']['controls'].items()} }"
          f", preflight rc {res['m6']['controls']['R1']['preflight_rc']}")
    print(f"check phase on {card}: {res['wall_s']:.1f} s (m1 "
          f"{m1['wall_s']:.1f}, m2 {m2['wall_s']:.1f}, m3 {m3['wall_s']:.1f}"
          f", m4 {m4['wall_s']:.1f}, m6 {res['m6']['wall_s']:.1f}, m5 wait "
          f"{m5['wait_s']:.1f})", flush=True)


# ---------------------------------------------------------------------------
# phase 3n: distribution (DTensor over one card, NCCL at world size 1)
# ---------------------------------------------------------------------------

#: (n2)'s prompts ([2, 64]: 128 rows a rank, the SpMM) and decode steps
DIST_PROMPT, DIST_DECODE = 64, 8
#: (n1)'s steps
DIST_STEPS = 2


def _dist_leaves(tree) -> dict:
    """{path: whole tensor} of a params tree, DTensors gathered."""
    from repro_torch.core.layouts import FixedMaskTensor

    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, FixedMaskTensor):
            walk(t.val, path + ("val",))
            walk(t.mask, path + ("mask",))
        elif hasattr(t, "shape"):
            out[".".join(path)] = t.full_tensor() if hasattr(
                t, "full_tensor") else t

    walk(tree, ())
    return out


def _dist_diff(a: dict, b: dict) -> dict:
    """Largest difference of two {path: tensor} trees, and whether every
    tensor is bitwise equal; masks must be equal."""
    import torch

    worst, same = 0.0, True
    for k, x in a.items():
        y = b[k]
        if x.dtype == torch.bool:
            assert bool((x == y).all()), f"mask {k} differs"
            continue
        d = (x.float() - y.float()).abs().max().item()
        worst, same = max(worst, d), same and bool((x == y).all())
    return {"max_abs_err": worst, "bitwise": same}


def _metric_diff(got: list, want: list) -> dict:
    rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
              for g, w in zip(got, want) for k in ("loss", "gnorm"))
    same = all(g[k] == w[k] for g, w in zip(got, want)
               for k in ("loss", "gnorm"))
    return {"max_rel_err": rel, "bitwise": same}


def dist_train(mesh, rules, device, smoke) -> dict:
    """(n1): the sharded train step over masked-sparse bert-base-sten, 2
    steps at remat "none" (twice) and "full", against the port's
    unsharded step (``launch/train.py:make_train_step``) on the same
    seeded batches.  Bound: losses and gradient norms within LOSS_RTOL,
    every weight within 2 lr a step of the unsharded one (the most AdamW
    moves a weight in a step), masks equal; bitwise is expected and
    reported."""
    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.dist import distribute_params
    from repro_torch.launch import steps as dsteps
    from repro_torch.launch.train import build_sparse_params, make_train_step
    from repro_torch.models import init_lm
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = (get_smoke if smoke else get_config)("bert-base-sten")
    params = build_sparse_params(init_lm(cfg, seed=0, device=device), 0.5)
    gen = torch.Generator(device=device).manual_seed(31)
    B, S = (2, 16) if smoke else (TRAIN_BATCH, TRAIN_SEQ)
    batches = [{k: torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                 device=device) for k in ("tokens", "labels")}
               for _ in range(DIST_STEPS)]
    opt = AdamWConfig()

    def run(step, p, st, shard):
        metrics, t0 = [], time.perf_counter()
        for b in batches:
            p, st, m = step(p, st, shard(b))
            metrics.append({k: float(m[k]) for k in ("loss", "gnorm")})
        torch.cuda.synchronize() if device == "cuda" else None
        return metrics, _dist_leaves(p), time.perf_counter() - t0

    p = _clone(params)
    plain = run(make_train_step(cfg, opt), p, adamw_init(p), lambda b: b)
    del p
    runs = {}
    for label, remat in (("none", "none"), ("none_again", "none"),
                         ("full", "full")):
        dp = distribute_params(params, mesh, rules)
        runs[label] = run(dsteps.make_train_step(
            cfg, opt, dsteps.StepConfig(remat=remat), mesh, rules), dp,
            adamw_init(dp), lambda b: dsteps.shard_batch(b, mesh, rules))
        del dp
    bound = 2 * opt.lr * DIST_STEPS
    res = {"label": cfg.name, "steps": DIST_STEPS, "batch": [B, S],
           "param_bound": bound, "loss_rtol": LOSS_RTOL,
           "plain_s": plain[2], "step_s": {k: v[2] / DIST_STEPS
                                           for k, v in runs.items()}}
    for label, (metrics, leaves, _) in runs.items():
        m, w = _metric_diff(metrics, plain[0]), _dist_diff(leaves, plain[1])
        assert m["max_rel_err"] <= LOSS_RTOL, (label, m)
        assert w["max_abs_err"] <= bound, (label, w)
        res[label] = {"metrics": m, "params": w, "loss": metrics}
    # remat: bitwise where two runs of "none" agree bitwise
    twice = _dist_diff(runs["none_again"][1], runs["none"][1])
    full = _dist_diff(runs["full"][1], runs["none"][1])
    if twice["bitwise"] and runs["none_again"][0] == runs["none"][0]:
        res["remat_check"] = "bitwise"
        assert full["bitwise"] and runs["full"][0] == runs["none"][0], \
            f"remat full differs from none: {full}"
    else:
        res["remat_check"] = "allclose"
        assert full["max_abs_err"] <= bound, full
    res["remat_vs_none"] = full
    res["bitwise"] = all(res[k]["metrics"]["bitwise"]
                         and res[k]["params"]["bitwise"] for k in runs)
    return res


def dist_serve(mesh, rules, device, smoke) -> dict:
    """(n2): qwen1.5-4b at full width, ``PHASE_DEPTH["dist/qwen1.5-4b"]``
    layers, n:m:g 1:4:8 gr64 ``attn=True``: the sharded prefill step of
    [2, 64] prompts and 8 sharded decode steps against the unsharded
    ``prefill`` / ``decode_step``: tokens equal, logits under the 5% rule
    (bitwise expected, reported), and the launches of the sharded run,
    counted from 0 right before it, with the DTensor boundary's routes."""
    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.dist import distribute_params
    from repro_torch.launch import steps as dsteps
    from repro_torch.models import decode_step, init_lm, prefill
    from repro_torch.serve import sparsify_for_serving

    if smoke:
        cfg, gr = get_smoke("qwen1.5-4b"), 16
    else:
        cfg, gr = dataclasses.replace(
            get_config("qwen1.5-4b"),
            n_layers=PHASE_DEPTH["dist/qwen1.5-4b"]), 64
    params = sparsify_for_serving(init_lm(cfg, seed=0, device=device), 1, 4,
                                  8, gr=gr, attn=True)
    gen = torch.Generator(device=device).manual_seed(32)
    tokens = torch.randint(0, cfg.vocab, (2, DIST_PROMPT), generator=gen,
                           device=device)
    S_c = DIST_PROMPT + DIST_DECODE
    dp = distribute_params(params, mesh, rules)
    sc = dsteps.StepConfig(remat="none")
    pre = dsteps.make_prefill_step(cfg, sc, mesh, rules, S_c)
    dec = dsteps.make_decode_step(cfg, sc, mesh, rules)

    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def greedy(pf, step, shard):
        """Prefill, then greedy decode steps; (logits whole, tokens,
        seconds)."""
        t0 = time.perf_counter()
        logits, cache = pf(shard({"tokens": tokens})["tokens"])
        out, toks = [full(logits)], []
        for i in range(DIST_DECODE):
            tok = out[-1].argmax(-1)[:, None].int()
            toks.append(tok)
            logits, cache = step(cache, shard({"t": tok})["t"],
                                 DIST_PROMPT + i)
            out.append(full(logits))
        torch.cuda.synchronize() if device == "cuda" else None
        return out, toks, time.perf_counter() - t0

    reset_counts()
    got = greedy(lambda t: pre(dp, {"tokens": t}),
                 lambda c, t, pos: dec(dp, c, t, pos),
                 lambda b: dsteps.shard_batch(b, mesh, rules))
    counts = read_counts()
    want = greedy(lambda t: prefill(params, cfg, t, S_c),
                  lambda c, t, pos: decode_step(params, cfg, t, c, pos),
                  lambda b: b)
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), \
        "sharded tokens differ from the unsharded run"
    held = hold_logits(list(zip(got[0], want[0])))
    routes = {k: v for k, v in counts["routes"].items() if "dtensor" in k}
    if device == "cuda":
        for k in KERNELS:
            assert counts[k] > 0, f"{k} never launched on the sharded path"
    for k in KERNELS:
        assert sum(v for r, v in routes.items()
                   if r.startswith(k + "/")) > 0, f"{k}: no boundary call"
    return {"label": cfg.name, "layers": cfg.n_layers, "gr": gr,
            "logits": held, "bitwise": all(
                torch.equal(a, b) for a, b in zip(got[0], want[0])),
            "counts": {k: counts[k] for k in KERNELS}, "routes": routes,
            "sharded_s": got[2], "plain_s": want[2]}


def dist_moe(mesh, rules, device, smoke) -> dict:
    """(n3): moonshot-v1-16b-a3b at full width, its first
    ``PHASE_DEPTH["dist/moonshot-v1-16b-a3b"]`` layers: the forward's
    logits with ``impl="shmap"`` on DTensor params under the mesh, and
    with ``combine="scatter"`` on one device, each against the gather /
    pjit forward, under the MoE checks' 5% logit rule (bitwise
    reported)."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.dist import distribute_params, use_rules
    from repro_torch.launch.steps import shard_batch
    from repro_torch.models import forward, init_lm, logits_of

    base = (get_smoke if smoke else get_config)("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(
        base, n_layers=PHASE_DEPTH["dist/moonshot-v1-16b-a3b"])
    params = init_lm(cfg, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(33)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen,
                           device=device)

    def moe_cfg(**kw):
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                **kw))

    with torch.no_grad():
        want = logits_of(params, cfg, forward(params, cfg, tokens))
        dp = distribute_params(params, mesh, rules)
        shm = moe_cfg(impl="shmap")
        with use_rules(mesh, rules), implicit_replication():
            td = shard_batch({"t": tokens}, mesh, rules)["t"]
            shmap = logits_of(dp, shm, forward(dp, shm, td)).full_tensor()
        del dp
        sca = moe_cfg(combine="scatter")
        scatter = logits_of(params, sca, forward(params, sca, tokens))
    out = {"label": cfg.name, "layers": cfg.n_layers}
    for name, got in (("shmap", shmap), ("scatter", scatter)):
        out[name] = {**hold_logits([(got[:, i], want[:, i])
                                    for i in range(got.shape[1])]),
                     "bitwise": bool(torch.equal(got, want))}
    return out


def dist_collectives(mesh, device) -> dict:
    """(n4): the collectives over "data" at world size 1: each equals its
    input (the mean of one rank's contribution), and the compressed
    all-reduce the ``ef_step`` payload scattered; bitwise."""
    import torch

    from repro_torch.core.layouts import FixedMaskTensor
    from repro_torch.dist import allreduce_mean, compressed_allreduce, \
        densify_allreduce_resparsify, ef_step, fixed_mask_value_allreduce

    gen = torch.Generator(device=device).manual_seed(34)
    x = torch.randn((1024, 1024), generator=gen, device=device)
    mask = torch.rand((1024, 1024), generator=gen, device=device) < 0.25
    g = FixedMaskTensor(x, mask)
    (vals, idx), mem = ef_step(x, torch.zeros_like(x), k_fraction=0.1)
    scattered = torch.zeros(x.numel(), device=device).index_put_(
        (idx.long(),), vals).reshape(x.shape)
    checks = {
        "allreduce_mean": (lambda: allreduce_mean(x, mesh, "data"), x),
        "fixed_mask_value_allreduce": (lambda: fixed_mask_value_allreduce(
            g, mesh, "data").to_dense(), g.to_dense()),
        "densify_allreduce_resparsify": (
            lambda: densify_allreduce_resparsify(g, mesh, "data").to_dense(),
            g.to_dense()),
        "compressed_allreduce": (lambda: compressed_allreduce(
            vals, idx, x.shape, mesh, "data"), scattered),
    }
    out = {"ef_complement": bool(torch.equal(scattered + mem, x))}
    assert out["ef_complement"]
    for name, (fn, want) in checks.items():
        got = fn()
        torch.cuda.synchronize() if device == "cuda" else None
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize() if device == "cuda" else None
        out[name] = {"bitwise": bool(torch.equal(got, want)),
                     "wall_ms": (time.perf_counter() - t0) * 1e3}
        assert out[name]["bitwise"], f"{name} differs from its input"
    return out


def dist_phase(card: str, device: str = "cuda", smoke: bool = False) -> dict:
    """Phase 3n (``python3 chip_smoke.py --dist``): the sharded steps,
    the expert-parallel MoE and the collectives under ``torch.distributed``
    at world size 1 (NCCL on the card: NCCL takes one rank a card), its
    process group started here from a ``HashStore``, over a (1, 1) mesh.
    That drives DTensor's dispatch, the kernels' DTensor boundary and
    NCCL's setup, and no real collective; multi-rank results are the CPU
    tests' (``tests/test_torch_dist_*``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import ShardingRules
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device=device)
        rules = ShardingRules()
        res = {"backend": backend, "world_size": dist.get_world_size(),
               "cards": torch.cuda.device_count() if device == "cuda" else 0}
        walls = {}
        for key, fn in (("n1", lambda: dist_train(mesh, rules, device, smoke)),
                        ("n2", lambda: dist_serve(mesh, rules, device, smoke)),
                        ("n3", lambda: dist_moe(mesh, rules, device, smoke)),
                        ("n4", lambda: dist_collectives(mesh, device))):
            t = time.perf_counter()
            res[key] = fn()
            walls[key] = time.perf_counter() - t
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        res["walls_s"] = walls
    finally:
        dist.destroy_process_group()
    res["phase_s"] = time.perf_counter() - t0
    return res


def report_dist(res, card) -> None:
    n1, n2, n3, n4 = (res[k] for k in ("n1", "n2", "n3", "n4"))
    w = res["walls_s"]
    print(f"dist (n1) on {card}: {n1['label']} masked 50%, "
          f"{n1['steps']} sharded steps at batch {n1['batch']} on a (1, 1) "
          f"mesh ({res['backend']}, world size {res['world_size']}) against "
          f"the unsharded step: loss/gnorm max rel err "
          f"{max(n1[k]['metrics']['max_rel_err'] for k in ('none', 'full')):.3e}"
          f" (bound {n1['loss_rtol']}), params max abs err "
          f"{max(n1[k]['params']['max_abs_err'] for k in ('none', 'full')):.3e}"
          f" (bound {n1['param_bound']:.1e}), bitwise "
          f"{'met' if n1['bitwise'] else 'NOT met'}; remat full vs none "
          f"{n1['remat_check']} ({n1['remat_vs_none']}); step "
          f"{ {k: round(v, 3) for k, v in n1['step_s'].items()} } s sharded, "
          f"{n1['plain_s'] / n1['steps']:.3f} s unsharded")
    print(f"dist (n2): {n2['label']} {n2['layers']} layers "
          f"(PHASE_DEPTH['dist/qwen1.5-4b']), 1:4:8 gr{n2['gr']} attn=True: "
          f"sharded prefill [2, {DIST_PROMPT}] + {DIST_DECODE} decode steps, "
          f"tokens equal, logits max abs err {n2['logits']['max_abs_err']:.3e}"
          f" (tol {n2['logits']['tol']:.3e}), bitwise "
          f"{'met' if n2['bitwise'] else 'NOT met'}; launches {n2['counts']},"
          f" boundary {n2['routes']}; {n2['sharded_s']:.2f} s sharded, "
          f"{n2['plain_s']:.2f} s unsharded")
    print(f"dist (n3): {n3['label']} {n3['layers']} layers "
          f"(PHASE_DEPTH['dist/moonshot-v1-16b-a3b']): shmap logits max abs "
          f"err {n3['shmap']['max_abs_err']:.3e}, scatter "
          f"{n3['scatter']['max_abs_err']:.3e} (tol "
          f"{n3['shmap']['tol']:.3e}), bitwise shmap "
          f"{n3['shmap']['bitwise']} scatter {n3['scatter']['bitwise']}")
    print(f"dist (n4): " + ", ".join(
        f"{k} bitwise {v['bitwise']} {v['wall_ms']:.3f} ms"
        for k, v in n4.items() if isinstance(v, dict)))
    print(f"dist phase on {card}: {res['phase_s']:.1f} s in its process "
          f"(n1 {w['n1']:.1f}, n2 {w['n2']:.1f}, n3 {w['n3']:.1f}, n4 "
          f"{w['n4']:.1f}); {res['cards']} card(s) visible", flush=True)


# ---------------------------------------------------------------------------
# phase 3o: the dry-run grid's cells and its count against the card
# ---------------------------------------------------------------------------

#: (o1)'s production cells: (arch, shape, --opt options)
DRYRUN_CELLS = (("mamba2-370m", "decode_32k", {}),
                ("qwen1.5-4b", "decode_32k", {"sparse": "nmg"}))
#: (o2): decode_32k's per-device shape on the 16x16 mesh (128 / 16 rows,
#: 32768 / 16 cache rows), and the timed steps
DRYRUN_B, DRYRUN_S, DRYRUN_REPS = 8, 2048, 20


def dryrun_cells(device: str = "cuda") -> list:
    """(o1): each of :data:`DRYRUN_CELLS` through ``run_cell`` on a fake
    process group of 256 ranks, its records written under
    ``chiprun_out/dryrun_smoke``; a cell that is not ok raises."""
    from repro_torch.launch import dryrun

    out = []
    for arch, shape, opts in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, False,
                              str(ROOT / "chiprun_out" / "dryrun_smoke"),
                              opts, device=device)
        assert rec["ok"], f"dry-run cell {arch} {shape} {opts}: " \
            f"{rec.get('error')}\n{rec.get('traceback', '')}"
        out.append({k: rec[k] for k in (
            "arch", "shape", "mesh", "opts", "roofline",
            "useful_flops_ratio", "flops_per_dev", "bytes_per_dev",
            "collective_bytes_per_dev", "kernels", "trace_s", "wall_s")})
    return out


def dryrun_count(device: str = "cuda", smoke: bool = False) -> dict:
    """(o2): qwen1.5-4b at full width, ``PHASE_DEPTH["dryrun/qwen1.5-4b"]``
    layers, 1:4:8 gr64 ``attn=True``, its decode step at batch
    :data:`DRYRUN_B` over :data:`DRYRUN_S` cache rows at world size 1:
    the count on meta (``analyze_program``) against the step on the card,
    timed by CUDA events (median of :data:`DRYRUN_REPS`, L2 not flushed),
    and the count's kernel nodes against one step's launches."""
    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.launch.cost_analysis import analyze_program, \
        roofline_terms
    from repro_torch.models import decode_step, init_cache, init_lm
    from repro_torch.serve import sparsify_for_serving

    if smoke:
        cfg, gr = get_smoke("qwen1.5-4b"), 16
    else:
        cfg, gr = dataclasses.replace(
            get_config("qwen1.5-4b"),
            n_layers=PHASE_DEPTH["dryrun/qwen1.5-4b"]), 64

    def build(dev):
        params = sparsify_for_serving(init_lm(cfg, seed=0, device=dev), 1, 4,
                                      8, gr=gr, attn=True)
        return params, init_cache(cfg, DRYRUN_B, DRYRUN_S, device=dev)

    def step(p, c, tok, pos):
        return decode_step(p, cfg, tok, c, pos)

    mp, mc = build("meta")
    cost = analyze_program(step, mp, mc, torch.empty(
        DRYRUN_B, 1, dtype=torch.int32, device="meta"), torch.empty(
        (), dtype=torch.int32, device="meta"))
    terms = roofline_terms(cost["flops"], cost["bytes"],
                           cost["collectives"]["total"])
    params, cache = build(device)
    gen = torch.Generator(device=device).manual_seed(33)
    tok = torch.randint(0, cfg.vocab, (DRYRUN_B, 1), generator=gen,
                        device=device, dtype=torch.int32)
    pos = torch.tensor(DRYRUN_S // 2, dtype=torch.int32, device=device)
    step(params, cache, tok, pos)                       # warm-up
    reset_counts()
    step(params, cache, tok, pos)
    counts = read_counts()
    launches = {k: counts[k] for k in KERNELS}
    counted = {k: cost["kernels"].get(k, 0) for k in KERNELS}
    ms = []
    if device == "cuda":
        for _ in range(DRYRUN_REPS):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            step(params, cache, tok, pos)
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
    med = statistics.median(ms) if ms else float("nan")
    bound_ms = terms.bound_s * 1e3
    res = {"label": cfg.name, "layers": cfg.n_layers, "gr": gr,
           "batch": DRYRUN_B, "cache_rows": DRYRUN_S,
           "flops": cost["flops"], "bytes": cost["bytes"],
           "compute_ms": terms.compute_s * 1e3,
           "memory_ms": terms.memory_s * 1e3, "dominant": terms.dominant,
           "bound_ms": bound_ms, "measured_ms": med,
           "ratio": med / bound_ms, "counted": counted,
           "launches": launches}
    assert counted == launches or device != "cuda", \
        f"the count's kernels {counted} != the card's launches {launches}"
    if device == "cuda":
        assert res["ratio"] >= 1.0, \
            f"measured {med:.4f} ms under the roofline bound {bound_ms:.4f}"
    return res


def dryrun_phase(card: str, device: str = "cuda", smoke: bool = False
                 ) -> dict:
    """Phase 3o: (o1) :func:`dryrun_cells`, (o2) :func:`dryrun_count`."""
    t0 = time.perf_counter()
    res = {"o1": [] if smoke else dryrun_cells(device)}
    t1 = time.perf_counter()
    res["o2"] = dryrun_count(device, smoke)
    res["walls_s"] = {"o1": t1 - t0, "o2": time.perf_counter() - t1}
    res["phase_s"] = time.perf_counter() - t0
    return res


def report_dryrun(res, card) -> None:
    for c in res["o1"]:
        t = c["roofline"]
        print(f"dryrun (o1) on {card}: {c['arch']} {c['shape']} {c['mesh']} "
              f"{c['opts']} ok, dominant {t['dominant']}: compute "
              f"{t['compute_s']:.6e} s, memory {t['memory_s']:.6e} s, "
              f"collective {t['collective_s']:.6e} s; useful_flops_ratio "
              f"{c['useful_flops_ratio']:.4f}; traced in {c['trace_s']} s "
              f"({c['wall_s']} s the cell)")
    o2 = res["o2"]
    print(f"dryrun (o2): {o2['label']} {o2['layers']} layers "
          f"(PHASE_DEPTH['dryrun/qwen1.5-4b']), 1:4:8 gr{o2['gr']} "
          f"attn=True, decode step at batch {o2['batch']} over "
          f"{o2['cache_rows']} rows: measured {o2['measured_ms']:.4f} ms "
          f"(median of {DRYRUN_REPS}, L2 not flushed), roofline bound "
          f"{o2['bound_ms']:.4f} ms ({o2['dominant']}; {o2['flops']:.4e} "
          f"FLOPs, {o2['bytes']:.4e} B), ratio {o2['ratio']:.3f} (>= 1 "
          f"met); kernels counted {o2['counted']}, launched "
          f"{o2['launches']} (equal)")
    w = res["walls_s"]
    print(f"dryrun phase on {card}: {res['phase_s']:.1f} s in its process "
          f"(o1 {w['o1']:.1f}, o2 {w['o2']:.1f})", flush=True)


# ---------------------------------------------------------------------------
# phase 3c: training at full width
# ---------------------------------------------------------------------------


def _clone(tree):
    """A deep copy of a params tree (tensors and FixedMask leaves)."""
    from repro_torch.core.layouts import FixedMaskTensor

    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, FixedMaskTensor):
        return FixedMaskTensor(tree.val.clone(), tree.mask.clone(),
                               tree.origin)
    return tree.clone()


def _kept(params) -> dict:
    from repro_torch.core.layouts import FixedMaskTensor

    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, FixedMaskTensor):
            out[".".join(path)] = t.mask.float().mean().item()

    walk(params, ())
    return out


def train_summary(label, out, counts, peak_gb, warm: int) -> dict:
    """Step times after the first ``warm`` steps (the first step, or the
    graph trainer's first chunk, which runs the step eagerly and captures
    it), tokens/s, losses."""
    steady = out["step_s"][warm:]
    step_ms = statistics.median(steady) * 1e3
    losses = out["losses"]
    assert all(math.isfinite(x) for x in losses), (label, losses)
    return {"label": label, "steps": len(losses),
            "step_ms_p50": step_ms,
            "step_ms_mean": statistics.mean(steady) * 1e3,
            "first_step_ms": out["step_s"][0] * 1e3,
            "tokens_per_s": TRAIN_TOKENS / (step_ms / 1e3),
            "loss_first": losses[0], "loss_last": losses[-1],
            "losses": losses, "recomputes": out["recomputes"],
            "peak_gb": peak_gb, "counts": counts,
            "kept": _kept(out["params"])}


def assert_same_training(graph, host, what) -> None:
    """The graph trainer's run and the host loop's, bit for bit: losses,
    gradient norms, recomputes, and every param, mask, moment and the
    step counter."""
    import torch

    from repro_torch.launch.graphs import state_tensors

    assert graph["losses"] == host["losses"], (what, "losses")
    assert graph["gnorms"] == host["gnorms"], (what, "gnorms")
    assert graph["recomputes"] == host["recomputes"], (what, "recomputes")
    a = state_tensors(graph["params"], graph["opt_state"])
    b = state_tensors(host["params"], host["opt_state"])
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), (what, "state")


TIMED_STEPS = 5


def time_graph_steps(multi, out, data, step0: int) -> dict:
    """Where a replayed step's time goes: chunks of ``TIMED_STEPS`` steps
    after the run (no pattern recompute: the ramp has ended) from its
    final state, each ending in its one host fetch; wall per step the
    median of 3 chunks, timed now, and one more chunk under torch.profiler
    by :func:`run_profiles`."""
    import torch

    from repro_torch.launch import train as ttrain

    params, state = out["params"], out["opt_state"]
    at = [step0]

    def one():
        s = at[0]
        at[0] += TIMED_STEPS
        assert not multi.recomputes(s, TIMED_STEPS, s + TIMED_STEPS)
        t0 = time.perf_counter()
        _, _, m = multi(params, state, ttrain.stack_batches(
            data, s, s + TIMED_STEPS), s, s + TIMED_STEPS)
        torch.stack((m["loss"], m["gnorm"])).cpu()
        return time.perf_counter() - t0

    one()
    wall = statistics.median(one() for _ in range(3))
    return profile_later(one, wall, {"step_wall_ms": wall / TIMED_STEPS
                                     * 1e3, "steps": TIMED_STEPS})


def time_eager_steps(step_fn, out, data, step0: int) -> dict:
    """The host loop's steps timed as :func:`time_graph_steps` times the
    graph's: ``TIMED_STEPS`` eager steps, each fetching its loss and
    gradient norm as the host loop does."""
    import torch

    params, state = out["params"], out["opt_state"]
    at = [step0]

    def one():
        s = at[0]
        at[0] += TIMED_STEPS
        t0 = time.perf_counter()
        for k in range(s, s + TIMED_STEPS):
            batch = {key: torch.as_tensor(v, device="cuda")
                     for key, v in data.batch_at(k).items()}
            _, _, m = step_fn(params, state, batch)
            float(m["loss"])
            float(m["gnorm"])
        return time.perf_counter() - t0

    one()
    wall = statistics.median(one() for _ in range(3))
    return profile_later(one, wall, {"step_wall_ms": wall / TIMED_STEPS
                                     * 1e3, "steps": TIMED_STEPS})


def _peak_since(held) -> float:
    import torch

    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 1e9


def _fresh_peak() -> int:
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def train_cli_run() -> dict:
    """(a) The CLI's default masked path at full width: ``--sparsity 0.75
    --gmp iterative`` over 20 steps (magnitude-pruned FixedMask leaves on
    ``mlp`` and ``attn.wo``, a pattern recompute before each step of the
    ramp, steps 2..16), through the graph trainer (the default: chunks of
    ``--log-every 5`` steps, the step captured once and replayed) and
    through ``--host-loop``, held bit for bit.  Neither training kernel is
    on this path."""
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import AdamWConfig

    argv = ["--arch", "bert-base-sten", "--steps", "20", "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--sparsity", "0.75",
            "--gmp", "iterative", "--log-every", "5", "--device", "cuda"]
    runs = {}
    for mode, extra in (("graph", []), ("eager", ["--host-loop"])):
        held = _fresh_peak()
        args = ttrain.parse_args(argv + extra)
        reset_counts()
        out = ttrain.run(args)
        counts = read_counts()
        peak = _peak_since(held)
        assert out["rc"] == 0
        assert all(counts[k] == 0 for k in KERNELS + TRAIN_KERNELS), counts
        assert out["recomputes"] == list(range(2, 17)), out["recomputes"]
        # the magnitude mask keeps |x| >= the k-th largest |x|: every bf16
        # value tied with it is kept too (one bf16 step holds up to ~0.3%
        # of these weights near the threshold)
        for name, kept in _kept(out["params"]).items():
            assert 0.25 <= kept <= 0.255, (name, kept)
        runs[mode] = (out, counts, peak)
    (g, gc, gpeak), (h, hc, hpeak) = runs["graph"], runs["eager"]
    assert_same_training(g, h, "run (a)")
    assert g["trainer"].graph.info["captured"]
    cfg = g["cfg"]
    data = SyntheticLMPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0))
    res = train_summary("a_cli_sparsity0.75", g, gc, gpeak, warm=5)
    res["eager"] = train_summary("a_cli_sparsity0.75", h, hc, hpeak, warm=1)
    res["graph"] = dict(g["trainer"].graph.info)
    res["timed_graph"] = time_graph_steps(g["trainer"], g, data, 20)
    res["timed_eager"] = time_eager_steps(
        ttrain.make_train_step(cfg, AdamWConfig()), h, data, 20)
    return res


def parity_numbers(cfg, params, batch) -> dict:
    """Run (b)'s first step (forward and backward) from the same state
    through the kernels and through the plain versions: the loss of each,
    and the ``mlp.wi`` gradient's relative error in the Frobenius norm."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as ttrain

    b = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    kept = []
    route = kops.matmul_threshold

    def recording(a, w, t):    # the fused route, reading each mask's share
        val, mask = route(a, w, t)
        kept.append(mask.float().mean())
        return val, mask

    kops.matmul_threshold = recording
    try:
        lk, _, gk = ttrain.loss_and_grads(params, cfg, b)
    finally:
        kops.matmul_threshold = route
    with plain_versions():
        lp, _, gp = ttrain.loss_and_grads(params, cfg, b)
    lk, lp = float(lk), float(lp)
    gwk = gk["layers"]["mlp"]["wi"].float()
    gwp = gp["layers"]["mlp"]["wi"].float()
    return {"loss_kernels": lk, "loss_plain": lp,
            "loss_rel_err": abs(lk - lp) / abs(lp),
            "wi_grad_rel_err": ((gwk - gwp).norm() / gwp.norm()).item(),
            "wi_grad_max_abs_err": (gwk - gwp).abs().max().item(),
            "wi_grad_max_abs": gwp.abs().max().item(),
            "threshold_kept_share": torch.stack(kept).mean().item()}


def train_parity(cfg, params, batch) -> dict:
    """:func:`parity_numbers`, held to its bounds: loss within 1e-3
    relative; the ``mlp.wi`` gradient (bf16) within 2**-6 relative in the
    Frobenius norm — the two forwards differ by the f32 summation order
    of the fused product (and any mask entry on the threshold), which
    bf16 activations turn into rounding flips of 2**-8 relative that
    compound over 12 layers."""
    p = parity_numbers(cfg, params, batch)
    assert p["loss_rel_err"] <= 1e-3, ("loss", p)
    assert p["wi_grad_rel_err"] <= 2 ** -6, ("mlp.wi gradient", p)
    assert 0.1 <= p["threshold_kept_share"] <= 0.9, \
        ("kept share of the threshold", p)
    return p


def lib_model(seed: int):
    """Run (b)'s model: full-width bert-base-sten with the inline threshold
    on ``mlp.wi``, seeded random weights, NMSparsifier(2, 4) FixedMask
    ``mlp.wo`` / ``attn.wo`` (the nm_mask kernel at the build); and its
    data stream, seeded alike.  Returns (cfg, params, data)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.builder import SparsityBuilder
    from repro_torch.core.layouts import FixedMaskTensor
    from repro_torch.core.sparsifiers import NMSparsifier
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.models import init_lm

    cfg = dataclasses.replace(get_config("bert-base-sten"),
                              mlp_inline_threshold=THRESHOLD)
    params = init_lm(cfg, seed=seed, device="cuda")
    sb = SparsityBuilder()
    for pat in ("*mlp.wo*", "*attn.wo*"):
        sb.set_weight(pat, NMSparsifier(2, 4), FixedMaskTensor)
    data = SyntheticLMPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=seed))
    return cfg, sb.sparsify_params(params), data


MARGIN_SEEDS = (2, 3, 4)


def train_margins(seeds=MARGIN_SEEDS, check: bool = True) -> list:
    """Run (b)'s first-step parity (kernels against plain versions) from
    fresh models at more seeds than the run's own: how much of the
    ``mlp.wi`` gradient's 2**-6 bound each uses.  With ``check`` a seed
    over a bound fails the run."""
    import torch

    out = []
    for seed in seeds:
        cfg, params, data = lib_model(seed)
        batch = data.batch_at(0)
        p = (train_parity if check else parity_numbers)(cfg, params, batch)
        out.append({"seed": seed, **p,
                    "wi_grad_share_of_bound": p["wi_grad_rel_err"] / 2 ** -6})
        del params
        torch.cuda.empty_cache()
    return out


def train_lib_run() -> dict:
    """(b) The library API at full width: ``mlp_inline_threshold=0.5`` on
    the dense ``mlp.wi`` and NMSparsifier(2, 4) FixedMask leaves on
    ``mlp.wo`` / ``attn.wo``, GMP iterative with recomputes before steps
    2, 5 and 8 of 10, through ``make_multi_step`` (chunks of 5, the step
    captured once: ``matmul_threshold`` runs inside the replayed step,
    ``nm_mask`` at the build and eagerly between replays) and through the
    host loop from a clone of the same start, held bit for bit.  The
    graph run's counts cover the build and the loop."""
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import AdamWConfig, GMPSchedule, adamw_init

    steps = 10
    held = _fresh_peak()
    reset_counts()
    cfg, params, data = lib_model(1)
    gmp = GMPSchedule(mode="iterative", target_sparsity=0.5, begin_step=2,
                      end_step=8, recompute_every=3, num_layers=cfg.n_layers)
    start = _clone(params)
    multi = ttrain.make_multi_step(cfg, AdamWConfig(), gmp, 5)
    g = ttrain.fast_loop(params, adamw_init(params), multi, data, start=0,
                         stop=steps, log_every=5)
    counts = read_counts()
    peak = _peak_since(held)
    held = _fresh_peak()
    reset_counts()
    step_fn = ttrain.make_train_step(cfg, AdamWConfig())
    h = ttrain.train_loop(_clone(start), adamw_init(start), step_fn, data,
                          start=0, stop=steps, device="cuda", gmp=gmp,
                          log_every=5)
    host_counts = read_counts()
    host_peak = _peak_since(held)
    assert_same_training(g, h, "run (b)")
    assert g["recomputes"] == [2, 5, 8], g["recomputes"]
    want_mt = cfg.n_layers * steps                    # one per forward
    want_nm = 2 * cfg.n_layers + 2 * len(g["recomputes"])
    assert counts["matmul_threshold"] == want_mt, (counts, want_mt)
    assert counts["nm_mask"] == want_nm, (counts, want_nm)
    assert all(counts[k] == 0 for k in KERNELS), counts
    assert host_counts["matmul_threshold"] == want_mt, host_counts
    assert host_counts["nm_mask"] == 2 * len(h["recomputes"]), host_counts
    assert multi.graph.info["captured"]
    for name, kept in _kept(g["params"]).items():
        assert kept == 0.5, (name, kept)
    parity = train_parity(cfg, start, data.batch_at(0))
    del start
    res = train_summary("b_lib_nm2:4_threshold0.5", g, counts, peak, warm=5)
    res["eager"] = train_summary("b_lib_nm2:4_threshold0.5", h, host_counts,
                                 host_peak, warm=1)
    res["parity"] = parity
    res["graph"] = dict(multi.graph.info)
    res["timed_graph"] = time_graph_steps(multi, g, data, steps)
    res["timed_eager"] = time_eager_steps(step_fn, h, data, steps)
    return res


def ckpt_phase() -> dict:
    """Checkpoint and resume at full width through the CLI: run (a)'s
    model and schedule over 6 steps with a checkpoint every 3 (the graph
    trainer), then a second run resumed from a copy of that run's step-3
    checkpoint in another directory; its losses for steps 3..5 and its
    final params, masks, moments and step counter must equal the first
    run's bit for bit, and so must the two final checkpoints' hashes."""
    import shutil
    import tempfile

    from repro_torch.launch import train as ttrain

    def argv(d, *extra):
        return ["--arch", "bert-base-sten", "--steps", "6", "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--sparsity",
                "0.75", "--gmp", "iterative", "--log-every", "3",
                "--ckpt-every", "3", "--ckpt-dir", str(d), "--device",
                "cuda", *extra]

    with tempfile.TemporaryDirectory() as tmp:
        a, b = Path(tmp) / "a", Path(tmp) / "b"
        t0 = time.perf_counter()
        full = ttrain.run(ttrain.parse_args(argv(a)))
        full_s = time.perf_counter() - t0
        b.mkdir()
        shutil.copytree(a / "step_00000003", b / "step_00000003")
        (b / "LATEST").write_text("3")
        t0 = time.perf_counter()
        res = ttrain.run(ttrain.parse_args(argv(b, "--resume")))
        resumed_s = time.perf_counter() - t0
        assert full["rc"] == res["rc"] == 0 and res["start_step"] == 3
        assert res["losses"] == full["losses"][3:], (res["losses"],
                                                     full["losses"])
        tail = {"params": full["params"], "opt_state": full["opt_state"],
                "losses": full["losses"][3:], "gnorms": full["gnorms"][3:],
                "recomputes": [s for s in full["recomputes"] if s >= 3]}
        assert_same_training(res, tail, "resume")
        man = [json.loads((d / "step_00000006" / "MANIFEST.json")
                          .read_text()) for d in (a, b)]
        assert man[0]["index"] == man[1]["index"]
        size = sum(f.stat().st_size for f in (a / "step_00000006").iterdir())
    del full, res
    return {"steps": 6, "resumed_at": 3, "bitwise": True,
            "full_run_s": full_s, "resumed_run_s": resumed_s,
            "ckpt_bytes": size, "leaves": man[0]["num_leaves"]}


def report_train(runs, card) -> None:
    for r in runs:
        c = r["counts"]
        gi = r["graph"]
        print(f"train[{r['label']}] on {card}: {r['steps']} steps, graph "
              f"trainer bitwise the host loop; graph {r['step_ms_p50']:.2f} "
              f"ms/step p50 after the first chunk ({r['step_ms_mean']:.2f} "
              f"mean, first chunk {r['first_step_ms']:.1f} a step), host "
              f"loop {r['eager']['step_ms_p50']:.2f} ms/step p50; "
              f"{r['tokens_per_s']:.0f} tok/s, loss {r['loss_first']:.4f} "
              f"-> {r['loss_last']:.4f}, peak {r['peak_gb']:.2f} GB "
              f"(host loop {r['eager']['peak_gb']:.2f}), recomputes "
              f"{len(r['recomputes'])}, launches nm_mask {c['nm_mask']} "
              f"matmul_threshold {c['matmul_threshold']}")
        print(f"    capture {gi['capture_ms']:.1f} ms + instantiate "
              f"{gi['instantiate_ms']:.1f} ms, pool "
              f"{gi['pool_bytes'] / 2**20:.1f} MiB, {gi['replays']} replays")
        for mode in ("graph", "eager"):
            p = r[f"timed_{mode}"]
            busy = p["device_busy_share"]
            n = p["steps"]
            print(f"    {mode} steps (no recompute, {n} a call): "
                  f"{p['step_wall_ms']:.3f} ms wall a step, device "
                  + ("not measured (profiler saw no device time)"
                     if busy is None else
                     f"busy {p['device_busy_ms'] / n:.3f} ms a step "
                     f"({busy * 100:.1f}%, wall/busy {1 / busy:.3f})")
                  + f", {p['launches'] / n:.0f} launches a step")
            for k in p["top_kernels"][:5]:
                print(f"    {k['device_us']:9.1f} us x{k['count']:4d} "
                      f"{k['name']}")


def report_runs(runs, card) -> None:
    for mode, key in (("graph", "metrics"), ("eager", "eager_metrics")):
        dense_p50 = runs[0][key]["tok_latency_p50"]
        for r in runs:
            m = r[key]
            over = m["tok_latency_p50"] / dense_p50
            r.setdefault("sparse_over_dense_tok_p50", {})[mode] = over
            c = r["counts"]
            print(f"serve[{r['label']}, {mode}] on {card}: "
                  f"{m['num_requests']} requests {m['num_tokens']} tokens, "
                  f"{m['throughput_tok_s']:.1f} tok/s, per-token p50 "
                  f"{m['tok_latency_p50'] * 1e3:.3f} ms p99 "
                  f"{m['tok_latency_p99'] * 1e3:.3f} ms, ttft p50 "
                  f"{m['ttft_p50'] * 1e3:.3f} ms p99 "
                  f"{m['ttft_p99'] * 1e3:.3f} ms, sparse/dense p50 "
                  f"{over:.3f}, decode steps {r['decode_steps']}, launches "
                  + " ".join(f"{k[4:]} {c[k]}" for k in KERNELS))


def report_graphs(graphs, card) -> None:
    for p in graphs:
        cg, sg = p["chunk_graph"], p["step_graph"]
        eb = p["eager_busy_share"]
        print(f"decode chunk[{p['label']}] on {card}: 8 steps at 4 slots, "
              f"replay bitwise eager ({p['bitwise']}); eager "
              f"{p['eager_wall_ms']:.2f} ms wall, busy "
              + ("not measured" if eb is None else
                 f"{p['eager_busy_ms']:.3f} ms ({eb * 100:.1f}%)")
              + f"; replayed {p['replay_wall_ms']:.3f} ms wall, busy "
              f"{p['replay_busy_ms']:.3f} ms ({p['replay_busy_from']}, "
              f"{p['replay_busy_share'] * 100:.1f}%, wall/busy "
              f"{p['replay_over_busy']:.3f}), event span "
              f"{p['replay_event_span_ms']:.3f} ms; "
              f"{p['launches_per_step']:.0f} launches/step, eager host "
              f"{p['eager_host_us_per_launch']:.2f} us/launch "
              f"({p['eager_enqueue_ms']:.2f} ms a chunk), replay enqueue "
              f"{p['replay_enqueue_ms']:.3f} ms")
        print(f"    capture: chunk {cg['capture_ms']:.1f} ms + instantiate "
              f"{cg['instantiate_ms']:.1f} ms, pool "
              f"{cg['pool_bytes'] / 2**20:.1f} MiB; step "
              f"{sg['capture_ms']:.1f} + {sg['instantiate_ms']:.1f} ms, "
              f"pool +{sg['pool_bytes'] / 2**20:.1f} MiB")
        for k in p["replay_top_kernels"][:4]:
            print(f"    {k['device_us']:9.1f} us x{k['count']:4d} {k['name']}")


#: the body of the kernels whose cases do not name one
# ---------------------------------------------------------------------------
# phase 3f: the programming model (layouts, dispatch, sparse operators,
# intermediate and gradient plans)
# ---------------------------------------------------------------------------

STEN_STEPS = 5
LOSS_RTOL = 1e-3


def _launches(counts: dict) -> dict:
    return {k: counts[k] for k in KERNELS + TRAIN_KERNELS if counts.get(k)}


def sten_library_phase(gen) -> list:
    """(s1) The library at the model's published shapes, bf16: each case
    run through the kernels (the counts zeroed right before, read right
    after) and again under :func:`plain_versions`, held to the plain
    result by the kernel phase's rule, then timed (L2 flushed).

    - ``NMTensor.from_dense`` of ``mlp.wo`` [3072, 768] at 2:4 and 16:32
      (one ``nm_mask`` launch): offsets and values bitwise;
    - ``sten.linear`` with ``mlp.wi`` [768, 3072] as GroupedNMTensor 1:4:8
      gr64 (sparse_dim 0), x of 4 rows (the GEMV route) and of 1024 rows
      (the SpMM route): f32 error within 1e-4 of the largest output plus
      one bf16 rounding step;
    - ``sten.matmul`` on a sparse_dim=1 GroupedNMTensor of ``mlp.wo``'s
      transpose [768, 3072] against 8 and 1024 columns (``nmg_matmul``'s
      GEMV and SpMM routes, f32 out): within 1e-4 of the largest output;
    - ``sparsified_op(torch.matmul, (ScalarThreshold(0.5), FixedMask,
      KeepAll, FixedMask))`` on DenseTensor [1024, 768] x [768, 3072]: one
      fused ``matmul_threshold`` launch, no post-sparsifier; values within
      1e-5 of the largest, the mask equal except within 1e-5 of t;
    - CSR @ dense, dense @ CSR and COO + COO at [3072, 768], 70% sparse,
      f32 (no kernel: plain torch ops): allclose to the dense result."""
    import warnings

    import torch

    from repro_torch import sten
    from repro_torch.core.layouts import CooTensor, CsrTensor, DenseTensor, \
        FixedMaskTensor, NMTensor
    from repro_torch.core.nmg import dense_to_grouped_nm
    from repro_torch.core.sparsifiers import KeepAll, ScalarThresholdSparsifier

    bf16 = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cases = []

    def run(label, fn, plain_check, kernels, timed=True):
        reset_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("error", sten.SparseFallbackWarning)
            got = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        for k in kernels:
            assert counts[k] == 1, (label, k, counts)
        with plain_versions():
            want = fn()
        err, tol = plain_check(got, want)
        assert err <= tol, (label, err, tol)
        c = {"case": label, "launches": _launches(counts),
             "routes": {k: v for k, v in counts["routes"].items()
                        if not k.endswith("/cuda")},
             "max_abs_err": err, "tol": tol}
        if timed:
            c["ms"] = time_ms(fn, flush)
            with plain_versions():
                c["plain_ms"] = time_ms(fn, flush)
        cases.append(c)
        return got

    def bitwise(got, want):
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        return (0.0 if same else float("inf")), 0.0

    wo = (torch.randn(3072, 768, generator=gen, device="cuda")
          / math.sqrt(3072)).to(bf16)
    for n, m in ((2, 4), (16, 32)):
        run(f"NMTensor.from_dense mlp.wo {n}:{m}",
            lambda n=n, m=m: (lambda t: (t.idx, t.val))(
                NMTensor.from_dense(wo, n, m)), bitwise, ("nm_mask",))

    def f32_rule(got, want):
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        tol = 1e-4 * max(1.0, top)
        if got.dtype == bf16:
            tol += 2 ** -8 * top
        return err, tol

    wi = dense_to_grouped_nm((torch.randn(768, 3072, generator=gen,
                                          device="cuda") / math.sqrt(768))
                             .to(bf16), 1, 4, 8, gr=64, sparse_dim=0)
    for rows, kernel in ((4, "nmg_gemv"), (1024, "nmg_spmm")):
        x = torch.randn(rows, 768, generator=gen, device="cuda").to(bf16)
        run(f"sten.linear mlp.wi 1:4:8 gr64 x[{rows}]",
            lambda x=x: sten.linear(x, wi), f32_rule, (kernel,))
    wo_t = dense_to_grouped_nm(wo.T.contiguous(), 1, 4, 8, gr=64,
                               sparse_dim=1)
    for cols, kernel in ((8, "nmg_gemv"), (1024, "nmg_spmm")):
        b = torch.randn(3072, cols, generator=gen, device="cuda").to(bf16)
        run(f"sten.matmul sparse_dim=1 [768, 3072] x [3072, {cols}]",
            lambda b=b: sten.matmul(wo_t, b), f32_rule, (kernel,))
    del wo, wi, wo_t

    a = torch.randn(TRAIN_TOKENS, 768, generator=gen, device="cuda").to(bf16)
    w = (torch.randn(768, 3072, generator=gen, device="cuda")
         / math.sqrt(768)).to(bf16)
    op = sten.sparsified_op(torch.matmul, sten.OutFormat(
        ScalarThresholdSparsifier(THRESHOLD), FixedMaskTensor, KeepAll(),
        FixedMaskTensor))
    y = a.double() @ w.double()
    near = (y.abs() - THRESHOLD).abs() <= 1e-5 * max(1.0, THRESHOLD)
    del y

    def threshold_rule(got, want):
        assert isinstance(got, FixedMaskTensor), type(got)
        diff = got.mask != want.mask
        assert not bool((diff & ~near).any()), "threshold mask differs"
        err = (got.val - want.val)[~diff].abs().max().item()
        return err, 1e-5 * max(1.0, want.val.abs().max().item())

    run("sparsified_op matmul + ScalarThreshold(0.5) [1024, 768] x "
        "[768, 3072]", lambda: op(DenseTensor(a), DenseTensor(w)),
        threshold_rule, ("matmul_threshold",))
    del a, w, near

    sp = sten.ScalarFractionSparsifier(0.7)
    wd = torch.randn(3072, 768, generator=gen, device="cuda")
    vd = torch.randn(3072, 768, generator=gen, device="cuda")
    csr = sten.apply_sparsifier(sp, wd, CsrTensor)
    b = torch.randn(768, 256, generator=gen, device="cuda")
    left = torch.randn(256, 3072, generator=gen, device="cuda")
    coo_a = sten.apply_sparsifier(sp, wd, CooTensor)
    coo_b = sten.apply_sparsifier(sp, vd, CooTensor)

    def allclose(got, want):
        got = got.to_dense() if hasattr(got, "to_dense") else got
        err = (got - want).abs().max().item()
        return err, 1e-4 * max(1.0, want.abs().max().item())

    dense = csr.to_dense()
    for label, fn, want in (
            ("CSR @ dense [3072, 768] x [768, 256]",
             lambda: sten.matmul(csr, b), dense @ b),
            ("dense @ CSR [256, 3072] x [3072, 768]",
             lambda: sten.matmul(left, csr), left @ dense),
            ("COO + COO [3072, 768]", lambda: sten.add(coo_a, coo_b),
             coo_a.to_dense() + coo_b.to_dense())):
        err, tol = allclose(fn(), want)
        assert err <= tol, (label, err, tol)
        cases.append({"case": label, "launches": {}, "max_abs_err": err,
                      "tol": tol, "ms": time_ms(fn, flush),
                      "density": csr.density()})
    del flush
    return cases


class _MaskRecorder:
    """Records every ``nm_mask`` result (through ``kernels/ops.py``, so
    the kernel or its plain version, whichever runs) while on."""

    def __init__(self):
        self.masks, self.on = [], False

    def __enter__(self):
        from repro_torch.kernels import ops as kops

        self._orig = kops.nm_mask

        def wrapped(x, n, m):
            out = self._orig(x, n, m)
            if self.on:
                self.masks.append(out.clone())
            return out

        kops.nm_mask = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops as kops

        kops.nm_mask = self._orig


def sten_plan():
    """(s2)'s plan: ``mlp.wi`` masked-dense n:m:g 1:4:8 gr64 (the default
    FixedMaskTensor), ``mlp.wo`` NMSparsifier(2, 4) FixedMask (nm_mask per
    layer), ``mlp.act`` NMSparsifier(2, 4) in every forward, and a
    magnitude gradient format on ``attn.wo``."""
    from repro_torch import sten

    sb = sten.SparsityBuilder()
    sb.set_weight("*mlp.wi", sten.GroupedNMSparsifier(1, 4, 8, gr=64,
                                                      sparse_dim=0))
    sb.set_weight("*mlp.wo", sten.NMSparsifier(2, 4))
    sb.set_interm("mlp.act", sten.NMSparsifier(2, 4))
    sb.set_weight_grad("*attn.wo", sten.OutFormat(
        external=sten.ScalarFractionSparsifier(0.5)))
    return sb


def sten_model_run(params, data, n_layers) -> dict:
    """Build the plan's params, train ``STEN_STEPS`` library-API steps
    (``loss_and_grads`` under the plan, then ``sparse_aware_update`` with
    the builder's gradient formats), recording the last step's
    ``mlp.act`` masks, then rebuild ``mlp.wo`` as a stacked NMTensor and
    run one eval forward under the plan.  Returns the losses, masks,
    counts per stage and times."""
    import warnings

    import torch

    from repro_torch import sten
    from repro_torch.configs import get_config
    from repro_torch.core.layouts import DenseTensor, NMTensor
    from repro_torch.launch import train as ttrain
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.sparse_update import sparse_aware_update

    cfg = get_config("bert-base-sten")
    sb = sten_plan()
    plan = sb.plan()
    out = {"counts": {}}
    reset_counts()
    t0 = time.perf_counter()
    p = sb.sparsify_params(params)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["counts"]["build"] = read_counts()
    state = adamw_init(p)
    opt = AdamWConfig()
    losses, step_s = [], []
    with _MaskRecorder() as rec, warnings.catch_warnings():
        warnings.simplefilter("error", sten.SparseFallbackWarning)
        for s in range(STEN_STEPS):
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in data.batch_at(s).items()}
            rec.on = s == STEN_STEPS - 1
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with plan:
                loss, _, grads = ttrain.loss_and_grads(p, cfg, batch)
            rec.on = False
            p, state, _ = sparse_aware_update(
                lambda g, st, pp: adamw_update(g, st, pp, opt), grads, state,
                p, grad_formats=sb.grad_formats())
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
            out["counts"][f"step{s}"] = read_counts()
        out["act_masks"] = rec.masks
        assert len(rec.masks) == n_layers, len(rec.masks)
        out["losses"], out["step_s"] = losses, step_s
        out["weight_masks"] = {k: p["layers"]["mlp"][k].mask.clone()
                               for k in ("wi", "wo")}
        # eval: mlp.wo as a stacked NMTensor through the n:m sparsifier
        reset_counts()
        wo = sten.SparsityBuilder().set_weight(
            "*mlp.wo", sten.NMSparsifier(2, 4), NMTensor).sparsify_params(
            {"mlp": {"wo": p["layers"]["mlp"]["wo"].to_dense()}})
        out["counts"]["eval_build"] = read_counts()
        ev = dict(p, layers=dict(p["layers"], mlp=dict(
            p["layers"]["mlp"], wo=wo["mlp"]["wo"])))
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in data.batch_at(STEN_STEPS).items()}
        disp = importlib.import_module("repro_torch.core.dispatch")
        conv = importlib.import_module("repro_torch.core.convert")
        disp.reset_dispatch_counters()
        conv.reset_conversion_log()
        reset_counts()
        with plan, torch.no_grad():
            ev_loss, _ = loss_fn(ev, cfg, batch)
        out["eval_loss"] = float(ev_loss)
        out["counts"]["eval"] = read_counts()
        out["eval_routes"] = sorted(
            (o, op, list(sig)) for (o, op, sig) in disp.dispatch_counters())
        out["eval_conversions"] = sorted({c[:2]
                                          for c in conv.conversion_log()})
        out["predict_route"] = disp.predict_route(
            "linear", (DenseTensor, NMTensor))
    out["params"], out["state"], out["eval_params"] = p, state, ev
    out["eval_batch"], out["cfg"], out["plan"] = batch, cfg, plan
    return out


def sten_model_phase(card) -> dict:
    """(s2) Full-width bert-base-sten (12 layers, d_model 768, d_ff 3072,
    vocab 30522, bf16, seeded random weights, batch 8 x 128 of the
    synthetic stream) under :func:`sten_plan`: the build, five library-API
    training steps and an eval forward with ``mlp.wo`` a stacked NMTensor,
    whose ``linear`` goes through the lossless NMTensor -> FixedMaskTensor
    conversion (the reference's route) with no fallback warning.  Run
    through the kernels, then from a clone of the same weights through
    the plain versions: each step's loss within 1e-3 (relative), the
    weight masks and the last step's ``mlp.act`` masks equal, and
    ``nm_mask`` launched once a layer at each build and in each forward.
    Reports ms a step (eager wall; device busy share by a profile run
    last), the conversions' share of the eval forward, and peak memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.models import init_lm, loss_fn

    cfg = get_config("bert-base-sten")
    L = cfg.n_layers
    params = init_lm(cfg, seed=5, device="cuda")
    start = _clone(params)
    data = SyntheticLMPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH, seed=5))
    held = _fresh_peak()
    k = sten_model_run(params, data, L)
    peak = _peak_since(held)
    del params
    with plain_versions():
        pl = sten_model_run(start, data, L)
    del start
    c = k["counts"]
    assert c["build"]["nm_mask"] == L, c["build"]
    for s in range(STEN_STEPS):
        assert c[f"step{s}"]["nm_mask"] == L, (s, c[f"step{s}"])
    assert c["eval_build"]["nm_mask"] == L and c["eval"]["nm_mask"] == L, c
    for stage in c.values():
        assert all(stage.get(x, 0) == 0 for x in KERNELS
                   + ("matmul_threshold",)), stage
    for a, b in zip(k["losses"], pl["losses"]):
        assert math.isfinite(a) and abs(a - b) <= LOSS_RTOL * abs(b), \
            (k["losses"], pl["losses"])
    assert abs(k["eval_loss"] - pl["eval_loss"]) <= LOSS_RTOL * abs(
        pl["eval_loss"]), (k["eval_loss"], pl["eval_loss"])
    for name in ("wi", "wo"):
        assert torch.equal(k["weight_masks"][name], pl["weight_masks"][name])
    assert all(torch.equal(a, b) for a, b in zip(k["act_masks"],
                                                 pl["act_masks"]))
    want_routes = {("impl", "linear", ("DenseTensor", "NMTensor")),
                   ("impl", "linear", ("DenseTensor", "FixedMaskTensor")),
                   ("impl", "linear", ("DenseTensor", "DenseTensor"))}
    assert {(o, op, tuple(sig)) for o, op, sig in k["eval_routes"]} == \
        want_routes, k["eval_routes"]
    assert set(k["eval_conversions"]) == {
        ("NMTensor", "FixedMaskTensor"), ("DenseTensor", "FixedMaskTensor")}
    pr = k["predict_route"]
    assert pr["target_sig"] == ("DenseTensor", "FixedMaskTensor") and \
        pr["conversions"] == (("NMTensor", "FixedMaskTensor"),), pr
    kept_wo = k["weight_masks"]["wo"].float().mean().item()
    kept_wi = k["weight_masks"]["wi"].float().mean().item()
    assert kept_wo == 0.5 and kept_wi == 0.25, (kept_wo, kept_wi)

    # times: the eval forward and its conversions (CUDA events), one
    # training step eager (wall, and device busy by a profile run last)
    from repro_torch.core.layouts import FixedMaskTensor
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.optim.sparse_update import sparse_aware_update

    conv = importlib.import_module("repro_torch.core.convert")
    ev, plan, batch = k["eval_params"], k["plan"], k["eval_batch"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def forward():
        with plan, torch.no_grad():
            loss_fn(ev, cfg, batch)

    def conversions():
        for w in (ev["layers"]["mlp"]["wo"], ev["layers"]["attn"]["wo"]):
            for one in w.unbind(0):
                conv.convert(one, FixedMaskTensor)

    fwd_ms, conv_ms = time_ms(forward, flush), time_ms(conversions, flush)
    del flush
    sb = sten_plan()
    p, state = k["params"], k["state"]

    def step():
        b = {kk: torch.as_tensor(v, device="cuda")
             for kk, v in data.batch_at(STEN_STEPS + 1).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plan:
            loss, _, grads = ttrain.loss_and_grads(p, cfg, b)
        sparse_aware_update(lambda g, st, pp: adamw_update(
            g, st, pp, AdamWConfig()), grads, state, p,
            grad_formats=sb.grad_formats())
        float(loss)
        return time.perf_counter() - t0

    step()
    wall = statistics.median(step() for _ in range(3))
    res = {"card": card, "losses": k["losses"],
           "plain_losses": pl["losses"],
           "loss_max_rel_err": max(abs(a - b) / abs(b) for a, b in
                                   zip(k["losses"], pl["losses"])),
           "eval_loss": k["eval_loss"], "plain_eval_loss": pl["eval_loss"],
           "eval_routes": k["eval_routes"],
           "eval_conversions": k["eval_conversions"],
           "predict_route": {kk: v for kk, v in k["predict_route"].items()},
           "counts": {st: _launches(v) for st, v in c.items()},
           "nm_mask_launches": sum(v.get("nm_mask", 0) for v in c.values()),
           "build_s": k["build_s"], "plain_build_s": pl["build_s"],
           "step_wall_ms_first": k["step_s"][0] * 1e3,
           "step_wall_ms": wall * 1e3,
           "plain_step_wall_ms_median": statistics.median(
               pl["step_s"][1:]) * 1e3,
           "eval_forward_ms": fwd_ms, "conversions_ms": conv_ms,
           "conversion_share": conv_ms / fwd_ms, "peak_gb": peak,
           "kept": {"mlp.wi": kept_wi, "mlp.wo": kept_wo}}
    res["profile"] = profile_later(step, wall)
    return res


def report_sten(lib, model) -> None:
    card = model["card"]
    print(f"sten library cases (bf16, L2 flushed, device ms) on {card}:")
    for c in lib:
        t = "" if "ms" not in c else f" | {c['ms']:.4f} ms" + (
            f" (plain {c['plain_ms']:.4f} ms)" if "plain_ms" in c else "")
        print(f"  sten {c['case']}: err {c['max_abs_err']:.2e} "
              f"(tol {c['tol']:.2e}) launches {c['launches']}{t}")
    print(f"sten model (bert-base-sten full width, plan: mlp.wi n:m:g "
          f"FixedMask, mlp.wo 2:4, mlp.act 2:4, attn.wo grad 50%) on "
          f"{card}: losses {[round(x, 4) for x in model['losses']]} "
          f"(plain max rel err {model['loss_max_rel_err']:.2e}), eval loss "
          f"{model['eval_loss']:.4f}; step {model['step_wall_ms']:.1f} ms "
          f"eager wall, device busy "
          f"{model['profile'].get('device_busy_ms') or 0:.1f} ms "
          f"({(model['profile'].get('device_busy_share') or 0) * 100:.1f}%, "
          f"{model['profile'].get('launches')} launches); eval forward "
          f"{model['eval_forward_ms']:.2f} ms, "
          f"conversions {model['conversions_ms']:.2f} ms "
          f"({model['conversion_share'] * 100:.1f}%); peak "
          f"{model['peak_gb']:.2f} GB; nm_mask launches "
          f"{model['nm_mask_launches']}")


# ---------------------------------------------------------------------------
# tuning phase (repro_torch.tune)
# ---------------------------------------------------------------------------

#: widths of the crossover sweep at the served widths, around decode's and
#: the short admission's 16
TUNE_MS = (8, 12, 16, 17, 20, 24, 32)
#: (model, weight) of the served projections the crossover is measured at
TUNE_WEIGHTS = (("bert", "wi"), ("bert", "wo_ffn"), ("qwen", "wq"),
                ("qwen", "wi"), ("qwen", "wo_ffn"))


def tune_cli() -> dict:
    """``python -m repro_torch.tune --quick --out <tmp>`` in a subprocess:
    its ``decision,key,value`` lines, and the table it wrote, loaded (a
    table that does not load fails the phase)."""
    import os
    import tempfile

    from repro_torch.tune import TuningTable

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "tune_table.json"
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.tune", "--quick", "--out",
             str(path)], capture_output=True, text=True, timeout=600,
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        wall = time.perf_counter() - t0
        if p.returncode:
            raise RuntimeError(f"python -m repro_torch.tune failed "
                               f"({p.returncode}):\n{p.stdout}\n{p.stderr}")
        table = TuningTable.load(str(path))
    lines = [ln for ln in p.stdout.splitlines()
             if re.match(r"^[a-z_]+,", ln)]
    for ln in lines:
        print(f"  tune cli: {ln}")
    assert len(table) > 0 and any(k.startswith("gemv_cuda/")
                                  for k in table.entries), table.entries
    assert any(k.startswith("spmm_cuda/") for k in table.entries)
    assert "spmm_block_elems" not in table.entries
    return {"wall_s": wall, "device": table.device, "entries": len(table),
            "lines": lines}


def crossover_phase(gen) -> list:
    """At the served projections (bf16 1:4:8 gr64, B = x.T): the tuned
    decode config (M = 4, the engine's slots) and SpMM split (N = 24, 32,
    64, its prompts past 16), each held against the plain version at the
    kernel phase's tolerance; then the GEMV and SpMM device times at
    ``TUNE_MS`` with the kernels' own configs and with the tuned ones (the
    packed gated weight also with its gate, as the model runs it), and the
    measured crossover of each."""
    import torch

    from repro_torch.core.nmg import dense_to_grouped_nm
    from repro_torch.kernels import nmg_gemv, nmg_spmm
    from repro_torch.tune import TuningTable, bench, routing

    bf16 = torch.bfloat16
    out = []
    for model, name in TUNE_WEIGHTS:
        K, N = MODELS[model]["shapes"][name]
        w = dense_to_grouped_nm(
            (torch.randn(K, N, generator=gen, device="cuda")
             / math.sqrt(K)).to(bf16), 1, 4, 8, gr=64, sparse_dim=0)
        table = TuningTable.for_device()
        ctx = dict(K=K, R=N, fmt=(1, 4, 8), gr=64, dtype=bf16)
        gcfg = bench.tune_gemv_cuda(table, M=4, reps=3, **ctx)
        scfg = bench.tune_spmm_cuda(table, Ns=(24, 32, 64), reps=3, **ctx)
        errs = {}
        for what, M, fn, plain in (
                ("gemv_cuda", 4, lambda b: nmg_gemv.nmg_gemv(
                    w, b, transpose_out=True, config=gcfg),
                 lambda b: nmg_gemv.nmg_gemv_plain(w, b, transpose_out=True)),
                ("spmm_cuda", 32, lambda b: nmg_spmm.nmg_spmm(
                    w, b, splits=scfg["splits"]),
                 lambda b: nmg_spmm.nmg_spmm_plain(w, b))):
            x = torch.randn(M, K, generator=gen, device="cuda").to(bf16)
            got, ref = fn(x.T), plain(x.T)
            err = (got - ref).abs().max().item()
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            assert err <= tol, (model, name, what, err, tol)
            errs[what] = err
        sweeps = {}
        # the packed gated weight also with its gate: what the model runs
        # (the fused FFN where the router fuses, else projection + gate)
        gated = (("gated", table, "silu"),) if name == "wi" and \
            MODELS[model]["ffn"] == "wi" else ()
        for which, tab, gate in (("own", None, None), ("tuned", table, None),
                                 *gated):
            routing.set_active_table(tab)
            try:
                recs = bench.sweep_m(w, TUNE_MS, dtype=bf16, reps=3,
                                     gate=gate)
            finally:
                routing.clear_active_table()
            sweeps[which] = {
                "gemv_ms": {r["M"]: r["us"] / 1e3 for r in recs
                            if r["path"] == "gemv"},
                "spmm_ms": {r["M"]: r["us"] / 1e3 for r in recs
                            if r["path"] == "spmm"},
                "crossover": bench.measured_crossover(recs)}
        own = nmg_gemv.row_plan(64, 4, w.val.shape[1] * w.val.shape[2], bf16)
        out.append({"model": model, "weight": name, "K": K, "N": N,
                    "gemv_cuda": gcfg,
                    "gemv_own": {"rows": own.rows, "parts": own.parts},
                    "spmm_cuda": scfg, "max_abs_err": errs, **sweeps})
    return out


def report_crossover(rows, card) -> None:
    for r in rows:
        for which in ("own", "tuned", "gated"):
            if which not in r:
                continue
            s = r[which]
            print(f"crossover[{r['model']} {r['weight']} K={r['K']} "
                  f"N={r['N']}, {which} configs] on {card}: " + " ".join(
                      f"M={m} gemv {s['gemv_ms'][m]:.4f} spmm "
                      f"{s['spmm_ms'][m]:.4f} ms;" for m in TUNE_MS)
                  + f" crossover {s['crossover']}")
        print(f"  chosen: gemv_cuda {r['gemv_cuda']} (own {r['gemv_own']}), "
              f"spmm_cuda {r['spmm_cuda']}; against plain: "
              f"{r['max_abs_err']}")


@contextlib.contextmanager
def default_routing():
    """Route with the shipped defaults (no table) inside the block."""
    from repro_torch.tune import routing

    held = routing.active_table()
    routing.clear_active_table()
    try:
        yield
    finally:
        routing.set_active_table(held)


def _projections(cfg, params):
    """(op, weight or group) of each routed projection of one layer."""
    attn, mlp = params["layers"]["attn"], params["layers"]["mlp"]
    one = {k: v.layer(0) for k, v in {**attn, **{f"mlp_{k}": v
                                      for k, v in mlp.items()}}.items()
           if hasattr(v, "layer")}
    return [("mm_fused_qkv", tuple(one[k] for k in ("wq", "wk", "wv"))),
            ("nmg_linear", one["wo"]),
            ("mm_gated" if cfg.gated_mlp else "nmg_linear", one["mlp_wi"]),
            ("nmg_linear", one["mlp_wo"])]


def _predicted(cfg, params, M) -> dict:
    """``predict_route`` of one forward at M rows: each projection's keys,
    once per layer."""
    import collections

    from repro_torch.kernels import ops

    keys = collections.Counter()
    for op, w in _projections(cfg, params):
        ws = w if op == "mm_fused_qkv" else None
        keys.update(ops.predict_route(
            op, None if ws else w, ws=ws, M=M, dtype=cfg.tdtype,
            device=(ws or (w,))[0].val.device))
    return {f"{k}/{p}": n * cfg.n_layers for (k, p), n in keys.items()}


def _route_kinds(routes) -> dict:
    """Calls per route with the provenance left out."""
    kinds: dict = {}
    for k, n in routes.items():
        kind = re.sub(r"\[(table|default)\]$", "", k)
        kinds[kind] = kinds.get(kind, 0) + n
    return kinds


def serve_tuned(cfg, params, label) -> dict:
    """The trace served by an engine warmed with ``warmup_engine(...,
    tune=True)`` beside one warmed with the default routing (n:m:g
    ``attn=True`` params): every routed counter of the tuned run reads
    ``[table]``; ``predict_route`` of each projection, summed over the
    layers, equals the counters of one replay of the decode chunk (times
    its steps) and of each prompt length's admission; the tokens equal
    the default run's where no route or config moved, and the logits
    through the tuned routing stay within ``logit_parity``'s bound of the
    default routing's; a different table activated after capture leaves
    a chunk and an admission replay bitwise unchanged.  Then per-token
    p50 and TTFT p99, tuned and default, over two runs each in turns."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.nmg_gemv import row_plan
    from repro_torch.serve import ServeEngine, warmup_engine
    from repro_torch.tune import TuningTable, routing

    t0 = time.perf_counter()
    reqs = requests_for(cfg)
    routing.clear_active_table()
    default = ServeEngine(params, cfg, **ENGINE_KW)
    warmup_engine(default, reqs)
    reset_counts()
    d_outs = default.run(reqs)
    d_counts = read_counts()
    tuned = ServeEngine(params, cfg, **ENGINE_KW)
    t1 = time.perf_counter()
    warmup_engine(tuned, reqs, tune=True)
    warm_s = time.perf_counter() - t1
    table = routing.active_table()
    assert table is not None and table.device.startswith("torch-cuda:")
    reset_counts()
    t_outs = tuned.run(requests_for(cfg))
    torch.cuda.synchronize()
    t_counts = read_counts()
    routed = [k for k in t_counts["routes"] if "[" in k]
    assert routed and all(k.endswith("[table]") for k in routed), \
        (label, t_counts["routes"])
    assert all(len(o.tokens) == 32 for o in t_outs)

    # predict_route against one replay of each program
    chunk = tuned._decode_chunk
    slots = ENGINE_KW["max_slots"]
    tok = np.arange(1, slots + 1, dtype=np.int32)
    pos = np.full(slots, 40, np.int32)
    saved = {k: v.clone() for k, v in tuned.kv.data.items()}
    reset_counts()
    first = chunk.run(tok, pos).clone()
    replay_routes = read_counts()["routes"]
    want = {k: n * tuned.decode_chunk
            for k, n in _predicted(cfg, params, slots).items()}
    assert replay_routes == want, (label, replay_routes, want)
    after_first = {k: v.clone() for k, v in tuned.kv.data.items()}
    rng = np.random.default_rng(5)
    for S in sorted(tuned.kv.prefill_graphs):
        reset_counts()
        tuned.kv.write_prefill(params, rng.integers(
            0, cfg.vocab, (1, S), dtype=np.int32), 1)
        assert read_counts()["routes"] == _predicted(cfg, params, S), \
            (label, S, read_counts()["routes"])
    for k, v in after_first.items():
        tuned.kv.data[k].copy_(v)
    prompt = rng.integers(0, cfg.vocab, (1, 32), dtype=np.int32)
    logits_a = tuned.kv.write_prefill(params, prompt, 2).clone()
    cache_a = {k: v.clone() for k, v in tuned.kv.data.items()}

    # a different table after capture: replays unchanged, bit for bit
    other = TuningTable.for_device()
    for k, v in (("decode_m_max", 0), ("fused_qkv", False),
                 ("fused_ffn", False), ("spmm_cuda", {"splits": 1}),
                 ("gemv_cuda", {"rows": 16, "parts": 1})):
        other.put(k, v)
    routing.set_active_table(other)
    try:
        for k, v in saved.items():
            tuned.kv.data[k].copy_(v)
        reset_counts()
        again = chunk.run(tok, pos).clone()
        assert torch.equal(again, first), f"{label}: chunk replay moved"
        assert read_counts()["routes"] == replay_routes
        assert all(torch.equal(tuned.kv.data[k], v)
                   for k, v in after_first.items())
        logits_b = tuned.kv.write_prefill(params, prompt, 2).clone()
        assert torch.equal(logits_b, logits_a), f"{label}: admission moved"
        assert all(torch.equal(tuned.kv.data[k], v)
                   for k, v in cache_a.items())
        assert _predicted(cfg, params, slots) != \
            {k: n // tuned.decode_chunk for k, n in replay_routes.items()}
    finally:
        routing.set_active_table(table)
    for k, v in saved.items():
        tuned.kv.data[k].copy_(v)

    # tokens where nothing moved; logits wherever something did
    moved = _route_kinds(d_counts["routes"]) != _route_kinds(
        t_counts["routes"])
    for op, w in _projections(cfg, params):
        w0 = w[0] if isinstance(w, tuple) else w
        ctx = ops._route_ctx(w0, cfg.tdtype)
        cfg_t, _ = routing.gemv_cuda_config(**ctx)
        own = row_plan(w0.gr, slots, w0.val.shape[1] * w0.val.shape[2],
                       cfg.tdtype)
        if cfg_t is not None and cfg_t != {"rows": own.rows,
                                           "parts": own.parts}:
            moved = True
        s_cfg, _ = routing.spmm_cuda_config(**ctx)
        if s_cfg is not None and s_cfg.get("splits") is not None:
            moved = True
    d_tokens = [o.tokens for o in d_outs]
    t_tokens = [o.tokens for o in t_outs]
    same = sum(a == b for a, b in zip(d_tokens, t_tokens))
    if not moved:
        assert same == len(d_tokens), f"{label}: tokens moved"
    parity = logit_parity(cfg, params, reference=default_routing)

    # timings, in turns: default, tuned, tuned, default
    runs = {"default": [], "tuned": []}
    for which, eng in (("default", default), ("tuned", tuned),
                       ("tuned", tuned), ("default", default)):
        eng.reset_metrics()
        eng.run(requests_for(cfg))
        runs[which].append(eng.metrics(label=which).to_dict())
    routing.clear_active_table()
    entries = {k: v for k, v in table.entries.items()
               if not k.startswith("matmul_latency/")}
    del default, tuned
    torch.cuda.empty_cache()
    return {"label": label, "wall_s": time.perf_counter() - t0,
            "tune_warmup_s": warm_s, "entries": entries,
            "routes_tuned": t_counts["routes"],
            "routes_default": d_counts["routes"], "moved": moved,
            "same_streams": f"{same}/{len(d_tokens)}", "parity": parity,
            "tok_p50_ms": {k: [m["tok_latency_p50"] * 1e3 for m in v]
                           for k, v in runs.items()},
            "ttft_p99_ms": {k: [m["ttft_p99"] * 1e3 for m in v]
                            for k, v in runs.items()}}


def report_tuned(r, card) -> None:
    print(f"tuned serving[{r['label']}] on {card}: warm-up with tuning "
          f"{r['tune_warmup_s']:.1f} s, phase {r['wall_s']:.1f} s; routes "
          f"moved: {r['moved']}, streams equal {r['same_streams']}, logits "
          f"vs default routing {r['parity']['max_abs_err']:.4f} (bound "
          f"{r['parity']['tol']:.4f}, argmax {r['parity']['argmax_agree']})")
    for k in ("tok_p50_ms", "ttft_p99_ms"):
        print(f"  {k}: tuned " + ", ".join(
            f"{v:.3f}" for v in r[k]["tuned"]) + " | default " + ", ".join(
            f"{v:.3f}" for v in r[k]["default"]))
    for k, v in sorted(r["entries"].items()):
        print(f"  entry {k} = {json.dumps(v)}")


BODY_OF = {"matmul_threshold": "tc"}


def kernels_line(cases, counts, train_counts, sten_counts,
                 family_counts) -> list:
    """One entry per TPU kernel (every ``pl.pallas_call`` body): the
    serving kernels at qwen1.5-4b shapes (decode M = 4, prompt N = 32)
    with the launches of its n:m:g run; the SpMM's two schedules (rows 3
    and 4) are one CUDA kernel, listed once for each; the training kernels
    at run (b)'s shapes with the launches of run (b).  ``sten_launches``
    is each kernel's launches on the programming-model path (phase 3f:
    its library cases and its full-width model run), ``family_launches``
    a serving kernel's on each n:m:g run of phases 3d, 3e, 3h, 3i and 3j
    and each n:m:g engine run of phase 3k."""
    rows = [  # name, kernel, source, replaces, (model, weight, M)
        ("nmg_gemv", "nmg_gemv", "nmg_gemv.cu", "nmg_gemv.py:45",
         ("qwen", "wo_ffn", 4)),
        ("nmg_qkv", "nmg_qkv", "nmg_gemv.cu", "nmg_fused.py:120",
         ("qwen", "wq|wk|wv", 4)),
        ("nmg_spmm", "nmg_spmm", "nmg_spmm.cu", "nmg_spmm.py:93",
         ("qwen", "wi", 32)),
        ("nmg_spmm[grid]", "nmg_spmm", "nmg_spmm.cu", "nmg_spmm.py:67",
         ("qwen", "wi", 32)),
        ("nmg_ffn", "nmg_ffn", "nmg_ffn.cu", "nmg_fused.py:136",
         ("qwen", "wi", 4)),
        ("nm_mask", "nm_mask", "nm_mask.cu", "nm_mask.py:26",
         ("bert-train", "mlp.wo", 0)),
        ("matmul_threshold", "matmul_threshold", "matmul_threshold.cu",
         "fused_sparse_matmul.py:24", ("bert-train", "mlp.wi", TRAIN_TOKENS)),
    ]
    kernels = []
    for name, kernel, src, replaces, (model, wname, M) in rows:
        c = next(c for c in cases if c["kernel"] == kernel
                 and c["model"] == model and c["weight"] == wname
                 and c["M"] == M)
        launches = (train_counts if kernel in TRAIN_KERNELS else counts)
        kernels.append({
            "name": name, "route": "cuda",
            "body": c.get("body", BODY_OF.get(kernel)), "gr": c.get("gr"),
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches[kernel],
            "sten_launches": sten_counts[kernel],
            **({} if kernel in TRAIN_KERNELS else {"family_launches": {
                label: fc[kernel] for label, fc in family_counts.items()}}),
            "max_abs_err": max(x["max_abs_err"] for x in cases
                               if x["kernel"] == kernel),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "shape": f"{wname} K={c['K']} N={c['N']} M={M}",
            **{k: c[k] for k in ("registers", "smem_bytes") if k in c}})
    return kernels


def main() -> int:
    import torch

    if len(sys.argv) >= 2 and sys.argv[1] in FAMILY_RUNS:
        return families_child(sys.argv[1], sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs one CUDA device", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import init_lm
    from repro_torch.serve import sparsify_for_serving

    t_start = time.perf_counter()
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sources = ("nmg_gemv", "nmg_spmm", "nmg_ffn", "nm_mask",
               "matmul_threshold")
    build_s = _build.build_all(sources)
    print(f"kernels built in {build_s:.1f} s")
    lap("build")
    for name in sources:   # one line per library: its entries' range
        log = _build.ptxas_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(
            r"(\d+) bytes spill stores", log))
        print(f"  ptxas {name}: {len(regs)} entries, "
              f"{min(regs, default=0)}-{max(regs, default=0)} registers, "
              f"{spills} bytes spill stores")

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = (kernel_phase(gen, "bert") + kernel_phase(gen, "qwen")
             + kernel_phase(gen, "starcoder2") + kernel_phase(gen, "gemma2")
             + any_gr_phase(gen) + train_kernel_phase(gen))
    # phase (e)'s widths, from a generator of their own (the earlier
    # cases' inputs stay as they were)
    gen_e = torch.Generator(device="cuda").manual_seed(24)
    cases += kernel_phase(gen_e, "paligemma") + kernel_phase(gen_e,
                                                              "minicpm3")
    # moonshot's widths, from a generator of their own as well
    cases += kernel_phase(torch.Generator(device="cuda").manual_seed(26),
                          "moonshot")
    # mamba2's and hymba's widths, from a generator of their own too
    gen_i = torch.Generator(device="cuda").manual_seed(27)
    cases += kernel_phase(gen_i, "mamba2") + kernel_phase(gen_i, "hymba")
    # whisper's widths (the SpMM at the encoder's 1500 frames among them)
    cases += kernel_phase(torch.Generator(device="cuda").manual_seed(28),
                          "whisper")
    # qwen's FFN in phase (l)'s 2:4:4 gr64 tier
    cases += kernel_phase(torch.Generator(device="cuda").manual_seed(29),
                          "qwen24")
    print(f"kernel phase: {len(cases)} cases within bounds ({card})")
    lap("kernel phase")
    for c in cases:
        lib = ("none" if c["library_ms"] is None
               else f"{c['library_ms']:.4f} ms")
        extra = "".join(f" {k} {c[k]:.4f}" for k in
                        ("topk_scatter_ms", "kept_share", "ms_f32_out")
                        if k in c)
        extra += "".join(f" {k} {c[k]}" for k in
                         ("fmt", "body", "gr", "parts", "n_m", "registers",
                          "smem_bytes", "splits") if k in c)
        print(f"  {c['model']} {c['kernel']:8s} {c['weight']:9s} "
              f"M={c['M']:3d} err {c['max_abs_err']:.2e} | kernel "
              f"{c['ms']:.4f} ms (host {c['host_ms']:.4f} ms) "
              f"plain {c['plain_ms']:.4f} ms library {lib} "
              f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}){extra}")

    # the tuning phase, part 1: the CLI, and the crossover and configs
    # at the served widths (a generator of its own: the later phases'
    # inputs stay as they were)
    t0 = time.perf_counter()
    tune = {"cli": tune_cli(),
            "crossover": crossover_phase(
                torch.Generator(device="cuda").manual_seed(22))}
    tune_s = time.perf_counter() - t0
    report_crossover(tune["crossover"], card)
    lap("tuning cli and crossover")

    # (a) bert-base-sten: dense, sparse FFN, sparse FFN + attention
    cfg = get_config("bert-base-sten")
    params = init_lm(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    sparse_ffn = sparsify_for_serving(params, 1, 4, 8, gr=64)
    sparse_all = sparsify_for_serving(params, 1, 4, 8, gr=64, attn=True)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    # gr16, the format of the CPU parity models (prefill through the GEMV
    # kernel's SpMM route): served through the kernels too
    sparse_gr16 = sparsify_for_serving(params, 1, 4, 8, gr=16, attn=True)
    runs = [serve_phase(cfg, params, "dense"),
            serve_phase(cfg, sparse_ffn, "sparse_ffn"),
            serve_phase(cfg, sparse_all, "sparse_attn"),
            serve_phase(cfg, sparse_gr16, "sparse_attn_gr16")]
    for r in runs[2:]:
        for k in ("nmg_gemv", "nmg_qkv", "nmg_spmm"):
            assert r["counts"][k] > 0, \
                f"{k} never launched on the {r['label']} path"
    assert runs[1]["counts"]["nmg_qkv"] == 0
    assert all(runs[0]["counts"][k] == 0 for k in KERNELS)
    assert all(r["counts"]["nmg_ffn"] == 0 for r in runs)
    report_runs(runs, card)
    parity = logit_parity(cfg, sparse_all)
    print(f"logit parity (bert attn=True, kernels vs plain): {parity}")
    parity16 = logit_parity(cfg, sparse_gr16)
    print(f"logit parity (bert attn=True gr16, kernels vs plain): "
          f"{parity16}")
    # timed now, profiled at the end (their profiles hold the params)
    graphs = [graph_phase(cfg, p, r["label"]) for p, r in zip(
        (params, sparse_ffn, sparse_all, sparse_gr16), runs)]
    prefills = [prefill_phase(cfg, params, "dense"),
                prefill_phase(cfg, sparse_all, "sparse_attn")]
    tune["serve"] = [serve_tuned(cfg, sparse_all, "bert_attn_gr64")]
    del params, sparse_ffn, sparse_all, sparse_gr16
    lap("bert (a)")

    # (b) qwen1.5-4b at full width and depth: dense, sparse (attn=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # the bert graph phases' state
    qcfg = get_config("qwen1.5-4b")
    t0 = time.perf_counter()
    qparams = init_lm(qcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    q_init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qsparse = sparsify_for_serving(qparams, 1, 4, 8, gr=64, attn=True)
    torch.cuda.synchronize()
    q_convert_s = time.perf_counter() - t0
    # init draws each stacked [L, ...] leaf in f32 before the cast, so the
    # peak so far is init's; serving's own peak is read separately
    q_setup_peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    torch.cuda.reset_peak_memory_stats()
    qruns = [serve_phase(qcfg, qparams, "qwen_dense"),
             serve_phase(qcfg, qsparse, "qwen_sparse")]
    qc = qruns[1]["counts"]
    # one fused FFN launch per layer for every decode-shaped forward: each
    # decode step, and each prefill of a prompt of at most 16 tokens
    short = sum(r.prompt.size <= 16 for r in requests_for(qcfg))
    want_ffn = qcfg.n_layers * (qruns[1]["decode_steps"] + short)
    assert qc["nmg_ffn"] == want_ffn, (qc["nmg_ffn"], want_ffn)
    for k in KERNELS:
        assert qc[k] > 0, f"{k} never launched on the qwen1.5-4b path"
    assert all(qruns[0]["counts"][k] == 0 for k in KERNELS)
    report_runs(qruns, card)
    q_peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    print(f"qwen1.5-4b on {card}: init {q_init_s:.2f} s, n:m:g conversion "
          f"{q_convert_s:.2f} s, peak device memory {q_setup_peak_gb:.2f} GB "
          f"in init + conversion, {q_peak_gb:.2f} GB serving (dense and "
          f"n:m:g params resident)")
    q_parity = logit_parity(qcfg, qsparse)
    print(f"logit parity (qwen attn=True, kernels vs plain): {q_parity}")
    q_graphs = [graph_phase(qcfg, qparams, "qwen_dense"),
                graph_phase(qcfg, qsparse, "qwen_sparse")]
    prefills += [prefill_phase(qcfg, qparams, "qwen_dense"),
                 prefill_phase(qcfg, qsparse, "qwen_sparse")]
    tune["serve"].append(serve_tuned(qcfg, qsparse, "qwen_attn_gr64"))
    del qparams, qsparse
    lap("qwen (b)")

    # (d) starcoder2-15b and gemma2-9b at full width, in a process of its
    # own (this one still holds the earlier phases' profiles, and a
    # profiler session would slow its launches)
    torch.cuda.empty_cache()
    # (e) paligemma-3b and minicpm3-4b the same way, in another process;
    # (h) moonshot-v1-16b-a3b at full width and arctic-480b at SMOKE;
    # (i) mamba2-370m and hymba-1.5b, recurrent state; (j)
    # whisper-large-v3, enc-dec; (k) the int8 KV cache and paged serving;
    # (l) SLO-controlled serving with resident sparsity tiers; (m) the
    # static checker, (m5)'s SLO 1.5 x bert's dense p50; (n) distribution,
    # the sharded steps over DTensor, NCCL at world 1, and (o) the dry-run
    bert_p50_ms = runs[0]["metrics"]["tok_latency_p50"] * 1e3
    kids = run_children((
        ("--families", 700, ()), ("--vlm-mla", 600, ()), ("--moe", 600, ()),
        ("--ssm", 500, ()), ("--encdec", 400, ()), ("--kvcache", 500, ()),
        ("--slo", 400, ()), ("--check", 300, (f"{bert_p50_ms * 1.5:.4f}",)),
        ("--dist", 240, ())))
    fam, vlm, moe, ssm, encdec, kvc, slo, chk, dst = kids.values()
    chk["held_main"] = len(R6_HELD)
    assert chk["held_main"] > 0, "no kernel-phase case held to R6"
    report_check(chk, card)
    report_dist(dst, card)
    report_dryrun(dst["o"], card)
    all_fams = (fam["families"] + vlm["families"] + moe["families"]
                + ssm["families"] + encdec["families"])
    fam_counts = {r["label"]: r["counts"] for f in all_fams
                  for r in f["runs"] if r["label"].endswith("_sparse")}
    fam_counts.update(kvc["counts"])
    fam_counts["qwen_slo"] = slo["l1"]["counts"]
    fam_counts["qwen_dist"] = dst["n2"]["counts"]
    for r in tune["serve"]:
        report_tuned(r, card)
    tune["wall_s"] = tune_s + sum(r["wall_s"] for r in tune["serve"])
    print(f"tuning phase on {card}: {tune['wall_s']:.1f} s (CLI "
          f"{tune['cli']['wall_s']:.1f} s, crossover and configs "
          f"{tune_s - tune['cli']['wall_s']:.1f} s, tuned serving "
          + ", ".join(f"{r['label']} {r['wall_s']:.1f} s"
                      for r in tune["serve"]) + ")")

    # (c) bert-base-sten training at full width: the CLI's masked path,
    # then the library API through both training kernels
    train = [train_cli_run(), train_lib_run()]
    lap("train (c)")
    ckpt = ckpt_phase()
    lap("checkpoint")
    print(f"checkpoint/resume (a's model, 6 steps, resumed at step 3) on "
          f"{card}: bitwise the uninterrupted run; {ckpt['leaves']} leaves, "
          f"{ckpt['ckpt_bytes'] / 2**20:.1f} MiB a checkpoint; runs "
          f"{ckpt['full_run_s']:.1f} s and {ckpt['resumed_run_s']:.1f} s")
    print(f"train parity (b, kernels vs plain): {train[1]['parity']}")
    margins = [{"seed": 1, **train[1]["parity"],
                "wi_grad_share_of_bound":
                    train[1]["parity"]["wi_grad_rel_err"] / 2 ** -6}]
    margins += train_margins()
    lap("train margins")
    for mg in margins:
        print(f"train parity (b) seed {mg['seed']}: loss rel err "
              f"{mg['loss_rel_err']:.3e} (bound 1e-3), mlp.wi gradient rel "
              f"err {mg['wi_grad_rel_err']:.5f} (bound 2**-6 = 0.015625, "
              f"{mg['wi_grad_share_of_bound'] * 100:.1f}% of it)")

    # (f) the programming model: the library at the model's shapes, then
    # full-width bert-base-sten under an intermediate and gradient plan
    sten_lib = sten_library_phase(gen)
    sten_model = sten_model_phase(card)
    lap("sten (f)")
    sten_counts = {kk: sum(c["launches"].get(kk, 0) for c in sten_lib)
                   + sum(v.get(kk, 0) for v in sten_model["counts"].values())
                   for kk in KERNELS + TRAIN_KERNELS}
    for kk in ("nmg_gemv", "nmg_spmm", "nm_mask", "matmul_threshold"):
        assert sten_counts[kk] > 0, f"{kk} never launched on the sten path"

    # every profiler session last: one slows every later launch
    run_profiles()
    lap("profiles")
    report_graphs([finish_graph(p) for p in graphs + q_graphs], card)
    report_prefill(prefills, card)
    report_train(train, card)
    report_sten(sten_lib, sten_model)

    kernels = kernels_line(cases, qc, train[1]["counts"], sten_counts,
                           fam_counts)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kind": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": build_s,
        "convert_s": convert_s, "qwen_init_s": q_init_s,
        "qwen_convert_s": q_convert_s, "qwen_setup_peak_gb": q_setup_peak_gb,
        "qwen_serve_peak_gb": q_peak_gb,
        "cases": cases, "runs": runs + qruns,
        "logit_parity": {"bert": parity, "bert_gr16": parity16,
                         "qwen": q_parity},
        "train_margins": margins,
        "graphs": graphs + q_graphs, "prefill": prefills,
        "train": train, "ckpt": ckpt, "families": fam, "vlm_mla": vlm,
        "moe": moe, "ssm": ssm, "encdec": encdec, "kvcache": kvc,
        "slo": slo, "check": chk, "dist": dst, "r6_held": R6_HELD,
        "sten": {"library": sten_lib, "model": sten_model},
        "tuning": tune,
        "kernels": kernels, "laps": LAPS,
        "wall_s": time.perf_counter() - t_start}, indent=1))
    print(f"smoke timeline on {card}: seconds since start at the end of "
          + ", ".join(f"{k} {v}" for k, v in LAPS.items()))
    print(json.dumps({"serve": {
        r["label"]: {mode: {
            "tok_s": round(r[key]["throughput_tok_s"], 2),
            "p50_ms": round(r[key]["tok_latency_p50"] * 1e3, 4),
            "p99_ms": round(r[key]["tok_latency_p99"] * 1e3, 4),
            "over_dense_p50": round(r["sparse_over_dense_tok_p50"][mode], 4)}
            for mode, key in (("graph", "metrics"),
                              ("eager", "eager_metrics"))}
        for r in runs + qruns},
        "chunk_wall_ms": {p["label"]: {
            "eager": round(p["eager_wall_ms"], 3),
            "replay": round(p["replay_wall_ms"], 3),
            "replay_busy": round(p["replay_busy_ms"], 3)}
            for p in graphs + q_graphs},
        "device_busy_share": {p["label"]: {
            "eager": p["eager_busy_share"], "replay": p["replay_busy_share"]}
            for p in graphs + q_graphs},
        "prefill_ms": {p["label"]: {r["S"]: {
            "replay": round(r["replay_wall_ms"], 3),
            "eager": round(r["eager_wall_ms"], 3),
            "replay_busy": r["replay_busy_ms"]} for r in p["lens"]}
            for p in prefills},
        "ttft_ms": {r["label"]: {mode: [
            round(r[key]["ttft_p50"] * 1e3, 3),
            round(r[key]["ttft_p99"] * 1e3, 3)]
            for mode, key in (("graph", "metrics"),
                              ("eager", "eager_metrics"))}
            for r in runs + qruns},
        "logit_err": {"bert": parity["max_abs_err"],
                      "bert_gr16": parity16["max_abs_err"],
                      "qwen": q_parity["max_abs_err"]},
        "logit_tol": {"bert": parity["tol"], "bert_gr16": parity16["tol"],
                      "qwen": q_parity["tol"]},
        "wi_grad_rel_err": {m["seed"]: m["wi_grad_rel_err"]
                            for m in margins},
        "qwen_peak_gb": {"setup": round(q_setup_peak_gb, 3),
                         "serve": round(q_peak_gb, 3)},
        "train": {r["label"]: {
            "step_ms_p50": round(r["step_ms_p50"], 3),
            "tok_s": round(r["tokens_per_s"], 1),
            "loss_first": round(r["loss_first"], 4),
            "loss_last": round(r["loss_last"], 4),
            "peak_gb": round(r["peak_gb"], 3),
            "host_loop_step_ms_p50": round(r["eager"]["step_ms_p50"], 3),
            **{f"{mode}_step": {
                "wall_ms": round(r[f"timed_{mode}"]["step_wall_ms"], 3),
                "device_busy_share": r[f"timed_{mode}"]["device_busy_share"],
                "launches": r[f"timed_{mode}"]["launches"]
                / r[f"timed_{mode}"]["steps"]}
               for mode in ("graph", "eager")},
            "capture_ms": round(r["graph"]["capture_ms"], 1),
            "instantiate_ms": round(r["graph"]["instantiate_ms"], 1),
            "pool_mib": round(r["graph"]["pool_bytes"] / 2**20, 1)}
            for r in train},
        "ckpt_resume_bitwise": ckpt["bitwise"],
        "kvcache": {
            "runs": {lab: {
                "tok_p50_ms": round(r["metrics"]["tok_latency_p50"] * 1e3, 4),
                "ttft_p50_ms": round(r["metrics"]["ttft_p50"] * 1e3, 3),
                "cache_mib": round(r["cache_bytes"] / 2**20, 1),
                **({"chunk_span_ms": round(r["chunk_span_ms"], 3)}
                   if "chunk_span_ms" in r else {}),
                **({"bound_ms": round(r["bound"]["bound_ms"], 4)}
                   if "bound" in r else {}),
                **({"deferred_admissions": r["stats"]["deferred_admissions"],
                    "preemptions": r["stats"]["preemptions"],
                    "shared_tokens": r["kv_stats"]["shared_tokens"],
                    "cow_copies": r["kv_stats"]["cow_copies"]}
                   if "kv_stats" in r else {})}
                for lab, r in kvc["runs"].items()},

            "fixed": {f["label"]: {
                "bitwise_steps": f["bitwise_steps"],
                "control_bitwise_steps": f["control_bitwise_steps"],
                "vs_model_dtype_cache": f["vs_model_dtype_cache"]}
                for f in kvc["fixed"]},
            "wall_s": round(kvc["wall_s"], 1)},
        "slo": {
            "tok_p50_ms": round(slo["l1"]["metrics"]["tok_latency_p50"]
                                * 1e3, 4),
            "tok_p99_ms": round(slo["l1"]["metrics"]["tok_latency_p99"]
                                * 1e3, 4),
            "ttft_p50_ms": round(slo["l1"]["metrics"]["ttft_p50"] * 1e3, 3),
            "ttft_p99_ms": round(slo["l1"]["metrics"]["ttft_p99"] * 1e3, 3),
            "attainment": slo["l1"]["metrics"]["slo_attainment"],
            "tokens_by_tier": slo["l1"]["tokens_by_tier"],
            "tpot_model_ms": round(slo["l1"]["tpot_model_s"] * 1e3, 4),
            **{k: slo["l1"]["stats"][k] for k in (
                "shed", "timeout", "deferred_admissions", "fault_retries",
                "tier_switches")},
            "warm_s": round(slo["warm_s"], 1),
            "pool_mib": {k: round(v, 1) for k, v in slo["pool_mib"].items()},
            "wall_s": round(slo["wall_s"], 1)},
        "dist": {
            "n1_bitwise": dst["n1"]["bitwise"],
            "n1_params_max_abs_err": max(dst["n1"][k]["params"]["max_abs_err"]
                                         for k in ("none", "full")),
            "n1_remat_check": dst["n1"]["remat_check"],
            "n2_logit_err": dst["n2"]["logits"]["max_abs_err"],
            "n2_bitwise": dst["n2"]["bitwise"],
            "n2_launches": dst["n2"]["counts"],
            "n2_boundary": dst["n2"]["routes"],
            "n3_logit_err": {k: dst["n3"][k]["max_abs_err"]
                             for k in ("shmap", "scatter")},
            "phase_s": round(dst["phase_s"], 1)},
        "dryrun": {
            "o1": {f"{c['arch']}/{c['shape']}": {
                "dominant": c["roofline"]["dominant"],
                "useful_flops_ratio": c["useful_flops_ratio"],
                "wall_s": c["wall_s"]} for c in dst["o"]["o1"]},
            "o2": {k: dst["o"]["o2"][k] for k in (
                "measured_ms", "bound_ms", "ratio", "counted", "launches")},
            "phase_s": round(dst["o"]["phase_s"], 1)},
        "check": {
            "r6_held": chk["held_main"],
            "qwen_diagnostics": chk["m3"]["diagnostics_per_rule"],
            "qwen_programs": len(chk["m3"]["programs"]),
            "differential_launches": chk["m4"]["launches"],
            "shed_before_arrival": chk["m5"]["shed_before_arrival"],
            "wall_s": round(chk["wall_s"], 1)},
        "families": {f["label"]: {
            "init_s": round(f["init_s"], 2),
            "init_peak_gb": round(f["init_peak_gb"], 3),
            "convert_s": round(f["convert_s"], 2),
            "convert_peak_gb": round(f["convert_peak_gb"], 3),
            "serve_peak_gb": round(f["serve_peak_gb"], 3),
            "tok_p50_ms": {r["label"]: [
                round(r["metrics"]["tok_latency_p50"] * 1e3, 4),
                round(r["eager_metrics"]["tok_latency_p50"] * 1e3, 4)]
                for r in f["runs"]},
            "step_bound_ms": {r["label"]: round(r["step_bound_ms"], 4)
                              for r in f["runs"]},
            "step_bytes": f["step_bytes"],
            "chunk_ms": {p["label"]: {
                "eager": round(p["eager_wall_ms"], 3),
                "replay": round(p["replay_wall_ms"], 3),
                "replay_span": round(p["replay_event_span_ms"], 3)}
                for p in f["graphs"]},
            "logit_err": f["parity"]["max_abs_err"],
            "logit_tol": f["parity"]["tol"],
            **({"window": {
                "ttft_ms": round(f["window"]["metrics"]["ttft_p50"] * 1e3, 3),
                "vs_full_forward": f["window"]["vs_full_forward"][
                    "max_abs_err"],
                "vs_plain": f["window"]["vs_plain"]["max_abs_err"],
                "tol": f["window"]["vs_full_forward"]["tol"],
                "rows_vs_prefill": f["window"]["rows_vs_prefill"],
                "controls": {k: {"rows_over": v.get("rows", {}).get(
                    "local", {}).get("rows_over"),
                    "logit_err": v["logits"]["max_abs_err"],
                    "logits_ok": v["logits"]["ok"]}
                    for k, v in f["window"]["controls"].items()}}}
               if "window" in f else {}),
            **{key: {
                "ttft_ms": round(f[key]["metrics"]["ttft_p50"] * 1e3, 3)
                if "metrics" in f[key] else None,
                "admission_ms": round(f[key]["admission_ms"], 3)
                if "admission_ms" in f[key] else None,
                "logit_err": f[key]["vs_full_forward"]["logits"][
                    "max_abs_err"],
                "logit_tol": f[key]["vs_full_forward"]["logits"]["tol"],
                "attn_rel_err": f[key]["vs_full_forward"]["attn"][
                    "max_rel_rms_err"],
                "vs_plain": f[key]["vs_plain"]["max_abs_err"],
                "control": {
                    "logit_err": f[key]["control"]["logits"]["max_abs_err"],
                    "logits_ok": f[key]["control"]["logits"]["ok"],
                    "attn_rel_err": f[key]["control"]["attn"][
                        "max_rel_rms_err"],
                    "attn_layers_over": f[key]["control"]["attn"][
                        "layers_over"]}}
               for key in ("prefix", "latent") if key in f},
            **({"moe": {
                "router_max_abs_err": f["moe"]["layers"]["router_max_abs_err"],
                "router_max_rel_rms_err":
                    f["moe"]["layers"]["router_max_rel_rms_err"],
                "attn_rel_err":
                    f["moe"]["layers"]["attn"]["max_rel_rms_err"],
                "margin": f["moe"]["layers"]["margin"],
                "teacher_forced_flips": f["moe"]["layers"]["flipped_tokens"],
                "pin_margin": f["moe"]["parity"]["margin"],
                "pinned_outside_teacher_forced_margin": f["moe"]["parity"][
                    "pinned_outside_teacher_forced_margin"],
                "pinned_unlike_own_top_k":
                    f["moe"]["parity"]["pinned_unlike_own_top_k"],
                "moe_rows_rel_err":
                    f["moe"]["parity"]["moe_rows"]["max_rel_rms_err"],
                "control_logit_err":
                    f["moe"]["parity"]["control"]["logits"]["max_abs_err"],
                "control_logits_ok":
                    f["moe"]["parity"]["control"]["logits"]["ok"],
                "control_moe_rows_rel_err":
                    f["moe"]["parity"]["control"]["attn"]["max_rel_rms_err"],
                "floor_logit_err":
                    f["moe"]["parity"]["floor"]["logits"]["max_abs_err"],
                "floor_moe_rows_rel_err":
                    f["moe"]["parity"]["floor"]["attn"]["max_rel_rms_err"],
                "dropped_per_layer":
                    f["moe"]["drops"]["dropped_per_layer"],
                "cost_ms": {k: round(f["moe"]["cost"][k], 3) for k in (
                    "moe_sublayers_ms", "expert_products_ms",
                    "expert_bound_ms")},
                "admission_ms": {p["label"]: {
                    r["S"]: round(r["replay_wall_ms"], 3)
                    for r in p["lens"]} for p in f["prefill"]}}}
               if "moe" in f else {}),
            **({"long": {
                "ttft_ms": round(f["long"]["metrics"]["ttft_p50"] * 1e3, 3),
                "tok_p50_ms": round(
                    f["long"]["metrics"]["tok_latency_p50"] * 1e3, 4),
                "state_bitwise": all(
                    v["bitwise"] for v in
                    f["long"]["state_vs_classic_prefill"].values()),
                "logit_err": f["long"]["vs_full_forward"]["logits"][
                    "max_abs_err"],
                "logit_tol": f["long"]["vs_full_forward"]["logits"]["tol"],
                "mixer_rel_err": f["long"]["vs_full_forward"]["attn"][
                    "max_rel_rms_err"],
                "vs_plain": f["long"]["vs_plain"]["max_abs_err"],
                "controls": {k: {
                    "mixer_rel_err": c["attn"]["max_rel_rms_err"],
                    "layers_over": c["attn"]["layers_over"],
                    "logits_ok": c["logits"]["ok"], "weak": c["weak"]}
                    for k, c in f["long"]["controls"].items()},
                "admission_ms": {p["label"]: {
                    r["S"]: round(r["replay_wall_ms"], 3)
                    for r in p["lens"]} for p in f["prefill"]}}}
               if "long" in f else {}),
            **({"encdec": {
                "ttft_ms": {r["label"]: [
                    round(r["metrics"]["ttft_p50"] * 1e3, 3),
                    round(r["metrics"]["ttft_p99"] * 1e3, 3)]
                    for r in f["runs"]},
                "admission_ms": {a["label"]: {
                    "eager_wall": round(a["eager_wall_ms"], 3),
                    "span": round(a["span_ms"], 3),
                    "encoder_span": round(a["encoder_span_ms"], 3)}
                    for a in f["encdec"]["admissions"]},
                "xattn_ms": {k: round(f["encdec"]["xattn_cost"][k], 3)
                             for k in ("xattn_sublayers_ms",
                                       "xattn_attention_ms",
                                       "cross_kv_bound_ms")},
                "full_context": {
                    "cross_kv_bitwise": all(f["encdec"]["full_context"][
                        "cross_kv_vs_classic_prefill"].values()),
                    "decode_ms_per_step": round(f["encdec"]["full_context"][
                        "decode_ms_per_step"], 3),
                    "logit_err": f["encdec"]["full_context"][
                        "vs_full_forward"]["logits"]["max_abs_err"],
                    "logit_tol": f["encdec"]["full_context"][
                        "vs_full_forward"]["logits"]["tol"],
                    "self_attn_rel_err": f["encdec"]["full_context"][
                        "vs_full_forward"]["self_attn"]["max_rel_rms_err"],
                    "cross_attn_rel_err": f["encdec"]["full_context"][
                        "vs_full_forward"]["cross_attn"]["max_rel_rms_err"],
                    "controls": {k: {
                        "cross_attn_rel_err":
                            c["cross_attn"]["max_rel_rms_err"],
                        "layers_over": c["cross_attn"]["layers_over"],
                        "weak": c["weak"]}
                        for k, c in f["encdec"]["full_context"][
                            "controls"].items()}}}}
               if "encdec" in f else {})}
            for f in all_fams},
        "tuning": {
            "wall_s": round(tune["wall_s"], 1),
            "crossover": {f"{r['model']}.{r['weight']}": {
                "own": r["own"]["crossover"],
                "tuned": r["tuned"]["crossover"],
                "gemv_cuda": r["gemv_cuda"], "spmm_cuda": r["spmm_cuda"]}
                for r in tune["crossover"]},
            "serve": {r["label"]: {
                "tok_p50_ms": r["tok_p50_ms"],
                "ttft_p99_ms": r["ttft_p99_ms"], "moved": r["moved"],
                "same_streams": r["same_streams"],
                "logit_err": r["parity"]["max_abs_err"]}
                for r in tune["serve"]}},
        "sten": {"loss_max_rel_err": sten_model["loss_max_rel_err"],
                 "step_wall_ms": round(sten_model["step_wall_ms"], 3),
                 "device_busy_share":
                     sten_model["profile"].get("device_busy_share"),
                 "conversion_share": round(
                     sten_model["conversion_share"], 4),
                 "peak_gb": round(sten_model["peak_gb"], 3),
                 "launches": {kk: v for kk, v in sten_counts.items() if v}},
        "wall_s": round(time.perf_counter() - t_start, 1)}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
