"""The traffic generators: deterministic by seed, the same trace for
every seed, and the distributions the mixes state."""

import collections
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.traffic import lm_batches, requests

PB = Path(__file__).resolve().parents[1]


def mix(name):
    return json.loads((PB / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["decode", "prefill"])
def test_backlog_deterministic_and_same_sizes_every_seed(name):
    m = mix(name)
    a = requests.generate(m, 2 ** 31 + 11, 49152, count=60)
    b = requests.generate(m, 2 ** 31 + 11, 49152, count=60)
    c = requests.generate(m, 5, 49152, count=60)
    assert all((x["prompt"] == y["prompt"]).all() and x["max_new"] == y["max_new"]
               for x, y in zip(a, b))
    # every seed: the same sizes in the same order, other tokens
    assert [(r["prompt"].size, r["max_new"]) for r in a] == \
        [(r["prompt"].size, r["max_new"]) for r in c]
    assert not all((x["prompt"] == y["prompt"]).all() for x, y in zip(a, c))
    # another schedule seed: other sizes
    d = requests.generate(dict(m, schedule_seed=1), 5, 49152, count=60)
    assert [(r["prompt"].size, r["max_new"]) for r in a] != \
        [(r["prompt"].size, r["max_new"]) for r in d]
    assert all(r["due_s"] == 0.0 for r in a)
    # a shorter cut is a prefix of a longer one
    e = requests.generate(m, 5, 49152, count=20)
    assert [(r["prompt"].size, r["max_new"]) for r in e] == \
        [(r["prompt"].size, r["max_new"]) for r in c[:20]]


@pytest.mark.parametrize("name", ["decode", "chat", "prefill"])
def test_sizes_follow_the_stated_shares_and_range(name):
    m = mix(name)
    n = 4000
    rs = requests.generate(dict(m, arrivals="backlog"), 3, 1000, count=n)
    got = collections.Counter(r["prompt"].size for r in rs)
    assert set(got) == set(m["prompt_lens"])
    for S, p in zip(m["prompt_lens"], m["prompt_probs"]):
        # five binomial standard deviations
        assert abs(got[S] - p * n) < 5 * (n * p * (1 - p)) ** 0.5
    outs = np.array([r["max_new"] for r in rs])
    lo, hi = m["output_min"], m["output_max"]
    assert outs.min() == lo and outs.max() == hi
    assert abs(outs.mean() - (lo + hi) / 2) < 5 * (hi - lo) / (12 * n) ** 0.5
    assert all(0 <= r["prompt"].min() and r["prompt"].max() < 1000
               for r in rs[:50])


def test_poisson_arrivals_independent_and_same_for_every_seed():
    m = mix("chat")
    a = requests.generate(m, 2 ** 31 + 3, 512, until_s=2000.0)
    b = requests.generate(m, 7, 512, until_s=2000.0)
    due = np.array([r["due_s"] for r in a])
    assert np.all(np.diff(due) > 0) and due[-1] <= 2000.0
    assert abs(len(a) / 2000.0 - m["rate"]) / m["rate"] < 0.05
    gaps = np.diff(np.concatenate([[0.0], due]))
    assert abs(np.std(gaps) / np.mean(gaps) - 1.0) < 0.1     # exponential
    # the time that 20 arrivals take varies as a Poisson process's does
    # (a coefficient of variation of 1 / sqrt(20)), it is not smoothed
    blocks = gaps[: len(gaps) // 20 * 20].reshape(-1, 20).sum(axis=1)
    assert abs(np.std(blocks) / np.mean(blocks) - 20 ** -0.5) < 0.05
    # every seed meets the same arrivals and sizes; a shorter window is a
    # prefix of a longer one
    assert [(r["due_s"], r["prompt"].size, r["max_new"]) for r in a] == \
        [(r["due_s"], r["prompt"].size, r["max_new"]) for r in b]
    c = requests.generate(m, 7, 512, until_s=100.0)
    assert [r["due_s"] for r in c] == [r["due_s"] for r in a[:len(c)]]
    assert a[len(c)]["due_s"] > 100.0


def test_lm_batches_deterministic_rows_differ():
    m = dict(mix("lm-32x512"), batch=4, seq=16)
    a = lm_batches.batches(torch, m, 2 ** 31 + 9, 1000, 100, 3, "cpu")
    b = lm_batches.batches(torch, m, 2 ** 31 + 9, 1000, 100, 3, "cpu")
    c = lm_batches.batches(torch, m, 2 ** 31 + 9, 1000, 101, 2, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][1:], c["tokens"])      # addressed by step
    assert not torch.equal(a["tokens"][0], a["tokens"][1])
    assert torch.equal(a["tokens"][:, :, 1:], a["labels"][:, :, :-1])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].max() < 1000
