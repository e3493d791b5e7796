"""Training batches from a mix's parameters: ``batch`` rows of ``seq``
tokens a step, uniform over the vocabulary, drawn on the device from
(seed, step), the labels the tokens shifted by one.  Every step's rows
differ; every seed asks for the same work."""

from __future__ import annotations


def batches(torch, mix: dict, seed: int, vocab: int, step0: int, n: int,
            device) -> dict:
    """{"tokens", "labels"} int32 [n, batch, seq] for steps step0 ..
    step0 + n - 1."""
    B, S = mix["batch"], mix["seq"]
    toks = torch.empty((n, B, S + 1), dtype=torch.int64, device=device)
    for i in range(n):
        gen = torch.Generator(device=device).manual_seed(
            (int(seed) * 1_000_033 + step0 + i) % (2 ** 63))
        toks[i] = torch.randint(0, vocab, (B, S + 1), generator=gen,
                                device=device)
    toks = toks.to(torch.int32)
    return {"tokens": toks[:, :, :-1].contiguous(),
            "labels": toks[:, :, 1:].contiguous()}
