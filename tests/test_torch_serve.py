"""The port's serving engine against the JAX package's, in the
``tests/test_serve_engine.py`` idiom: the same request trace through the
reference engine and the port's engine, with the same (bridged) weights,
dense and n:m:g, gives the same token streams.  Plus the port's own
engine contracts (chunked decode equals the per-token loop, host sampling
matches the reference's)."""

import numpy as np
import pytest

from repro.serve import Request as JRequest, SamplingParams as JSampling, \
    ServeEngine as JEngine, sample_token as j_sample
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as launch
from repro_torch.serve import Request, SamplingParams, ServeEngine, \
    sample_token, summarize

from tests._torch_compat import smoke_setup

# prompt lengths: two above the GEMV/SpMM crossover (16), two below
PROMPTS = (20, 6, 20, 6)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in PROMPTS]


def _engine_streams(setup):
    """Four requests through two slots (so admission happens while other
    slots decode), chunked greedy decode: identical tokens per request.
    Returns the port's kernel counters of the run."""
    jcfg, tcfg, jp, tp = setup
    prompts = _prompts(jcfg.vocab)
    kw = dict(max_slots=2, max_seq_len=28, decode_chunk=4)
    want = JEngine(jp, jcfg, **kw).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    tops.reset_kernel_counters()
    got = ServeEngine(tp, tcfg, device="cpu", **kw).run(
        [Request(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    assert [o.uid for o in got] == [o.uid for o in want]
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, (g.uid, g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason == "length"
    return tops.kernel_counters()


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_engine_token_streams_equal_reference(sparse):
    c = _engine_streams(smoke_setup(sparse))
    if sparse:
        assert c[("nmg_qkv", "fused[default]")] > 0
        assert c[("nmg_linear", "spmm[default]")] > 0
        assert c[("nmg_linear", "gemv[default]")] > 0


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_qwen_engine_token_streams_equal_reference(sparse):
    """qwen1.5-4b SMOKE (gated MLP, seeded nonzero QKV biases): the same
    token streams as the reference engine; the n:m:g decode runs the fused
    FFN launch."""
    c = _engine_streams(smoke_setup(sparse, "qwen1.5-4b", 3))
    assert (("nmg_ffn", "fused[default]") in c) == sparse
    if sparse:
        assert c[("nmg_qkv", "fused[default]")] > 0
        assert c[("nmg_linear", "spmm[default]")] > 0


def test_chunked_decode_equals_per_token_loop():
    _, tcfg, _, tp = smoke_setup(True)
    prompts = _prompts(tcfg.vocab)

    def serve(chunk):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=7,
                        stop_tokens=(3,)) for i, p in enumerate(prompts)]
        return ServeEngine(tp, tcfg, max_slots=3, max_seq_len=28,
                           decode_chunk=chunk, device="cpu").run(reqs)

    a, b = serve(1), serve(5)
    assert [o.tokens for o in a] == [o.tokens for o in b]
    assert all(len(o.tokens) <= 7 for o in a)


def test_non_greedy_sampling_matches_reference():
    """Host sampling: same logits, same seeded numpy stream, same ids."""
    logits = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    for kw in (dict(greedy=True), dict(greedy=False, temperature=0.7,
                                       top_k=5, seed=3)):
        want = j_sample(logits, JSampling(**kw), np.random.default_rng(9))
        got = sample_token(logits, SamplingParams(**kw),
                           np.random.default_rng(9))
        assert got == want


def test_metrics_and_rejection():
    _, tcfg, _, tp = smoke_setup(False)
    eng = ServeEngine(tp, tcfg, max_slots=2, max_seq_len=12, device="cpu")
    outs = eng.run([Request(uid=0, prompt=np.arange(1, 6), max_new_tokens=4),
                    Request(uid=1, prompt=np.arange(1, 30),
                            max_new_tokens=2)])
    assert [o.finish_reason for o in outs] == ["length", "rejected"]
    met = eng.metrics()
    assert met.num_requests == 1 and met.num_rejected == 1
    assert met.num_tokens == 4 and np.isfinite(met.tok_latency_p50)
    assert np.isnan(summarize([], 0.0).throughput_tok_s)


def test_launch_serve_cli_on_cpu(capsys):
    rc = launch.main(["--arch", "bert-base-sten", "--smoke", "--engine",
                      "--sparse", "--nm", "1:4:8",
                      "--requests", "3", "--prompt-len", "18",
                      "--gen-len", "4", "--device", "cpu", "--no-warmup"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[sparse] 3 requests, 12 tokens" in out
    assert "served 3 requests" in out


def test_launch_serve_cli_qwen_on_cpu(capsys):
    rc = launch.main(["--arch", "qwen1.5-4b", "--smoke", "--engine",
                      "--sparse", "--nm", "1:4:8",
                      "--requests", "3", "--prompt-len", "18",
                      "--gen-len", "4", "--device", "cpu", "--no-warmup"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[sparse] 3 requests, 12 tokens" in out
    assert "served 3 requests" in out
