"""The plain reference against the port at small sizes on the CPU: the
frozen n:m:g pruning equals the port's conversion, the f32 decoder
equals the port's f32 forward, and the f32 training steps equal the
port's trainer run in f32."""

import numpy as np
import pytest
import torch

import perfbench_sizes as sizes
from perfbench import weights
from perfbench.reference import decoder, nmg_prune, serve_check, train_ref

from repro_torch.core import nmg
from repro_torch.models.common import ModelConfig


@pytest.mark.parametrize("shape", [(128, 64), (96, 40), (256, 192)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_nmg_mask_equals_the_ports_conversion(shape, dtype):
    g = torch.Generator().manual_seed(shape[0] * 7 + shape[1])
    w = torch.randn(shape, generator=g).to(dtype)
    ours = nmg_prune.nmg_mask(w, 1, 4, 8, 64)
    port = nmg.grouped_nm_mask(w, 1, 4, 8, gr=64, sparse_dim=0).bool()
    assert torch.equal(ours, port)
    assert ours.float().mean().item() == pytest.approx(0.25, abs=0.05)


def test_pruned_layer_weights_equal_the_ports_serving_weights():
    from repro_torch.serve import sparsify_for_serving

    conf = sizes.serve_config()
    cfg, sp = conf["model"], conf["sparsity"]
    params = weights.dense_params(torch, cfg, 5, "cpu", torch.bfloat16)
    served = sparsify_for_serving(params, sp["n"], sp["m"], sp["g"],
                                  gr=sp["gr"], attn=sp["attn"])
    flat = {k: weights.draw_leaf(torch, cfg, 5, k, "cpu", torch.bfloat16)
            for k in weights.LEAVES}
    for layer in range(cfg["n_layers"]):
        w = serve_check.layer_weights(flat, layer, sp)
        for k, (grp, name) in {"wq": ("attn", "wq"), "wo": ("attn", "wo"),
                               "wi": ("mlp", "wi"),
                               "wo2": ("mlp", "wo")}.items():
            got = served["layers"][grp][name].layer(layer).to_dense().float()
            assert torch.equal(w[k], got), (layer, k)


def _port_logits(cfg, params, tokens):
    from repro_torch.models.transformer import forward, logits_of

    mcfg = ModelConfig(**cfg)
    return logits_of(params, mcfg, forward(params, mcfg, tokens)).float()


def test_decoder_equals_the_ports_forward_in_f32():
    cfg = dict(sizes.model(), dtype="float32")
    params = weights.dense_params(torch, cfg, 11, "cpu", torch.float32)
    toks = torch.randint(0, cfg["vocab"], (2, 24),
                         generator=torch.Generator().manual_seed(1))
    port = _port_logits(cfg, params, toks)
    x = decoder.embed(cfg, params["embedding"], toks)
    L = params["layers"]
    for i in range(cfg["n_layers"]):
        w = {"ln1": L["ln1"][i], "ln2": L["ln2"][i],
             **{k: L["attn"][k][i] for k in ("wq", "wk", "wv", "wo")},
             "wi": L["mlp"]["wi"][i], "wo2": L["mlp"]["wo"][i]}
        x = decoder.layer(cfg, w, x)
    ref = decoder.logits(x, params["final_norm"], params["lm_head"])
    assert torch.allclose(ref, port, atol=2e-4, rtol=1e-4)


def test_served_gaps_are_zero_for_the_references_own_tokens():
    conf = sizes.serve_config()
    cfg, sp = conf["model"], conf["sparsity"]
    prompt = np.arange(5, 21, dtype=np.int32)
    # greedy tokens of the reference itself lie at its best: gap 0
    flat = {k: weights.draw_leaf(torch, cfg, 3, k, "cpu", torch.bfloat16)
            for k in weights.LEAVES}
    toks = list(prompt)
    for _ in range(6):
        x = decoder.embed(cfg, flat["embedding"].float(),
                          torch.as_tensor(np.array(toks, np.int64)))
        for layer in range(cfg["n_layers"]):
            x = decoder.layer(cfg, serve_check.layer_weights(flat, layer, sp),
                              x)
        lg = decoder.logits(x[-1:], flat["final_norm"].float(),
                            flat["lm_head"].float())
        toks.append(int(lg.argmax()))
    served = toks[len(prompt):]
    out = serve_check.gaps(cfg, sp, 3, [(prompt, served)], "cpu")
    assert out["program"] == {"mean": 0.0, "max": 0.0} and out["tokens"] == 6
    wrong = [(t + 1) % cfg["vocab"] for t in served]
    got = serve_check.gaps(cfg, sp, 3, [(prompt, wrong)], "cpu")["program"]
    assert got["mean"] > 0 and got["max"] >= got["mean"]


def test_training_reference_equals_the_ports_trainer_in_f32():
    from perfbench import train
    from perfbench.traffic import lm_batches

    conf = sizes.train_config()
    conf["model"]["dtype"] = "float32"
    mix = sizes.train_mix()
    res = train.run(torch, {"config": conf, "traffic": mix,
                            "limits": sizes.limits("bert-gmp.train"),
                            "seed": 2 ** 31 + 21, "seconds": 0.5,
                            "trace": False, "device": "cpu", "t_start": 0.0})
    gaps = res["gaps"]
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-3
    assert res["program"]["losses"][0] == pytest.approx(
        res["reference"]["losses"][0], rel=1e-5)
    # the schedule recomputed the masks at step 100 (20.3% pruned)
    assert train_ref.gmp_sparsity(conf["training"]["gmp"], 100) == \
        pytest.approx(0.75 * (1 - 0.9 ** 3))
    fb = lm_batches.batches(torch, mix, 1, 512, 100, 1, "cpu")
    assert fb["tokens"].shape == (1, mix["batch"], mix["seq"])
