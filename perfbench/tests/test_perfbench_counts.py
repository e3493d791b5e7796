"""The work counts against hand-worked bytes and FLOPs at the
configurations' published widths."""

import json
from pathlib import Path

import pytest

from perfbench.counts import work

PB = Path(__file__).resolve().parents[1]


def conf(name):
    return json.loads((PB / "configs" / f"{name}.json").read_text())


SC2 = conf("starcoder2-15b.nmg-1-4-8-gr64")
BERT = conf("bert-base-sten.gmp75")


def test_nmg_work_mlp_wi_decode_by_hand():
    # mlp.wi [6144, 24576] at 1:4, 64 rows a group, 16 rows of input
    flops, nbytes = work.nmg_work(6144, 24576, SC2["sparsity"], 16)
    nnz = 6144 * 24576 // 4                        # 37,748,736 kept values
    assert flops == 2 * nnz * 16 == 1_207_959_552
    index = (24576 // 64) * (6144 // 4) * 4        # int32 per kept column a group
    assert nbytes == nnz * 2 + index + 16 * 6144 * 2 + 16 * 24576 * 2
    assert nbytes == 75_497_472 + 2_359_296 + 196_608 + 786_432


def test_decode_step_bound_starcoder2():
    # 40 layers x (wq, wk, wv, wo, wi, wo) at 1:4; memory bound at M = 16
    s = work.nmg_call_s(SC2["model"], SC2["sparsity"], 16)
    per_layer_vals = (6144 * 6144 * 2 + 6144 * 512 * 2 + 6144 * 24576 * 2) // 4 * 2
    assert s > 40 * per_layer_vals / 3.35e12
    assert s < 1.1 * 40 * per_layer_vals / 3.35e12
    # an admission of 3072 tokens is compute bound
    flops, nbytes = work.nmg_work(6144, 24576, SC2["sparsity"], 3072)
    assert work.roofline_s(flops, nbytes) == flops / 989e12


def test_token_flops_starcoder2_and_bert():
    sc2 = work.token_flops(SC2["model"], SC2["sparsity"])
    dense = 40 * 2 * (6144 * 6144 * 2 + 6144 * 512 * 2 + 6144 * 24576 * 2)
    assert sc2 == pytest.approx(dense / 4 + 2 * 6144 * 49152)
    b = work.token_flops(BERT["model"], None)
    assert b == 12 * 2 * (4 * 768 * 768 + 2 * 768 * 3072) + 2 * 768 * 30522


def test_attention_and_train_step_flops_by_hand():
    m = BERT["model"]
    assert work.attn_flops(m, 10) == 4 * 12 * 12 * 64 * 10
    assert work.prompt_attn_flops(m, 4) == 4 * 12 * 768 * (1 + 2 + 3 + 4)
    step = work.train_step_flops(m, 32, 512)
    dense = 12 * (4 * 768 * 768 + 2 * 768 * 3072) + 768 * 30522
    attn = 32 * 4 * 12 * 768 * (512 * 513 // 2)
    assert step == 3 * (2 * dense * 32 * 512 + attn)
    assert 11e12 < step < 12e12                    # ~11.6 TFLOP a step


def test_peaks_are_the_data_sheet():
    assert work.PEAKS["bf16_flop_s"] == 989e12
    assert work.PEAKS["hbm_byte_s"] == 3.35e12
