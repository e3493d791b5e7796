"""The port's cell grid (``repro_torch.configs.registry``) against the
reference's (``repro.configs.registry``): the shapes, the runnable cells,
the skip reasons and the input specs (the port's meta tensors against the
reference's ``jax.ShapeDtypeStruct``s, shape and dtype), and the shape-only
state the dry-run builds on the ``meta`` device: ``init_lm`` and the n:m:g
conversion draw, search and allocate nothing there, and give the shapes
and dtypes the CPU path gives."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro_torch.configs import registry as treg
from repro_torch.configs import get_config, get_smoke

ARCHS = list(jreg.ARCHS)


def test_shapes_equal_the_reference():
    assert list(treg.SHAPES) == list(jreg.SHAPES)
    for name, s in treg.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jreg.SHAPES[name])


@pytest.mark.parametrize("paper", [False, True])
def test_runnable_cells_equal_the_reference(paper):
    assert treg.runnable_cells(paper) == jreg.runnable_cells(paper)
    assert len(treg.runnable_cells(paper)) == (44 if paper else 40)
    assert sum(r is None for _, _, r in treg.runnable_cells()) == 33


@pytest.mark.parametrize("arch", ARCHS)
def test_skip_reason_equal_the_reference(arch):
    for shape in treg.SHAPES:
        assert treg.skip_reason(arch, shape) == jreg.skip_reason(arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    """Every input of every shape (and a batch override), on meta: the
    reference's shapes and dtypes, the modality stubs where it puts
    them (whisper's frames capped at ENC_LEN)."""
    tcfg, jcfg = treg.get_arch(arch), jreg.get_arch(arch)
    assert tcfg == get_config(arch) and treg.get_smoke(arch) == \
        get_smoke(arch)
    for shape in treg.SHAPES:
        for over in (None, 3):
            got = treg.input_specs(tcfg, treg.SHAPES[shape],
                                   batch_override=over)
            want = jreg.input_specs(jcfg, jreg.SHAPES[shape],
                                    batch_override=over)
            assert list(got) == list(want), (arch, shape)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (arch, k)
                assert np.dtype(str(t.dtype).replace("torch.", "")) == \
                    np.dtype(want[k].dtype), (arch, k)
    if arch == "whisper-large-v3":
        spec = treg.input_specs(tcfg, treg.SHAPES["prefill_32k"])
        assert spec["enc_embeds"].shape[1] == 1500


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _leaves(getattr(tree, f.name))]
    return []


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "gemma2-9b", "minicpm3-4b",
                                  "moonshot-v1-16b-a3b", "hymba-1.5b",
                                  "whisper-large-v3"])
def test_meta_init_lm_has_the_cpu_shapes_and_draws_nothing(arch,
                                                            monkeypatch):
    """``init_lm(device="meta")`` gives every leaf of the CPU init at its
    shape and dtype, on meta, with no generator and no draw."""
    from repro_torch.models import init_lm

    cfg = get_smoke(arch)
    cpu = init_lm(cfg, seed=0, device="cpu")

    def no_draw(*a, **k):
        raise AssertionError("a meta init drew")

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", no_draw)
    monkeypatch.setattr(torch, "Generator", no_draw)
    meta = init_lm(cfg, device="meta")
    a, b = _leaves(cpu), _leaves(meta)
    assert [(tuple(t.shape), t.dtype) for t in a] == \
        [(tuple(t.shape), t.dtype) for t in b]
    assert all(t.device.type == "meta" for t in b)


def test_cpu_init_unchanged_by_the_meta_path():
    """The CPU draws are the seeded generator's, as before: two inits of
    one seed are bitwise equal and another seed differs."""
    from repro_torch.models import init_lm

    cfg = get_smoke("qwen1.5-4b")
    a, b, c = (init_lm(cfg, seed=s, device="cpu") for s in (0, 0, 1))
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert not torch.equal(a["embedding"], c["embedding"])


@pytest.mark.parametrize("fmt", [(1, 4, 8, 16), (2, 4, 16, 8), (2, 4, 4, 64)])
def test_meta_conversion_gives_the_storage_without_a_search(fmt,
                                                            monkeypatch):
    """``dense_to_grouped_nm`` of a meta weight: the CPU conversion's
    leaves at their shapes and dtypes, and no assignment search."""
    from repro_torch.core import nmg

    n, m, g, gr = fmt
    x = torch.randn(160, 96, generator=torch.Generator().manual_seed(0))
    cpu = nmg.dense_to_grouped_nm(x, n, m, g, gr=gr, sparse_dim=0)
    for name in ("_greedy_assign", "_swap_refine", "_exact_assign"):
        monkeypatch.setattr(nmg, name, lambda *a, **k: pytest.fail("search"))
    meta = nmg.dense_to_grouped_nm(x.to("meta"), n, m, g, gr=gr,
                                   sparse_dim=0, method="swap")
    a, b = _leaves(cpu), _leaves(meta)
    assert [(tuple(t.shape), t.dtype) for t in a] == \
        [(tuple(t.shape), t.dtype) for t in b]
    assert (meta.n, meta.m, meta.g, meta.gr, meta.dense_shape) == \
        (cpu.n, cpu.m, cpu.g, cpu.gr, cpu.dense_shape)
