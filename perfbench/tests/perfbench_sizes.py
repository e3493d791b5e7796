"""Small configurations for the CPU tests: the cells' own traffic and
format at sizes a CPU run can hold."""

import copy
import json
from pathlib import Path

PB = Path(__file__).resolve().parents[1]


def model(d=64, layers=2, heads=4, kv=2, hd=16, ff=256, vocab=512):
    return {"name": "test", "vocab": vocab, "d_model": d, "n_layers": layers,
            "n_heads": heads, "n_kv_heads": kv, "head_dim": hd, "d_ff": ff,
            "attn_type": "gqa", "act": "gelu", "gated_mlp": False,
            "rope_theta": 10000.0, "dtype": "bfloat16",
            "attn_dtype": "float32"}


def serve_config(**kw):
    conf = json.loads((PB / "configs" /
                       "starcoder2-15b.nmg-1-4-8-gr64.json").read_text())
    conf["model"] = model(**kw)
    return conf


def train_config(**kw):
    conf = json.loads((PB / "configs" /
                       "bert-base-sten.gmp75.json").read_text())
    conf["model"] = model(**kw)
    return conf


def traffic(name, **kw):
    mix = json.loads((PB / "traffic" / f"{name}.json").read_text())
    mix = copy.deepcopy(mix)
    mix.update(kw)
    return mix


def limits(cell):
    return json.loads((PB / "limits" / f"{cell}.json").read_text())


def decode_mix(**kw):
    base = dict(slots=4, context=96, prompt_lens=[8, 16],
                prompt_probs=[0.5, 0.5], output_min=8, output_max=24,
                backlog=24, check={"tokens": 10 ** 6,
                                            "max_requests": 10 ** 6})
    base.update(kw)
    return traffic("decode", **base)


def train_mix(**kw):
    base = dict(batch=4, seq=32, chunk=5, feed_steps=40)
    base.update(kw)
    return traffic("lm-32x512", **base)
