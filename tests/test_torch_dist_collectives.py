"""The port's collectives and compression (``repro_torch.dist``) against
the reference's on the same inputs.

The collectives run on eight gloo ranks spawned once for the module
(``launch/mesh.py:run_ranks``, ``tests/_torch_dist_ranks.py:collectives``),
each rank passing its own contribution (the port's deliberate difference:
the reference's single controller passes each replica's contribution as
one replicated array, ROADMAP C2).  ``ef_step`` and ``plan_remesh`` are
held to the reference on one process.  Bounds: the means are sums of
eight f32 terms over eight, held to the numpy mean at rtol 1e-6; the
value-only all-reduce equals the densified one bitwise; ``ef_step``'s
payload and residual equal the reference's bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.dist.compression import compressed_allreduce as j_compressed
from repro.dist.compression import ef_step as j_ef_step
from repro.dist.elastic import plan_remesh as j_plan_remesh
from repro_torch.dist import ef_step, plan_remesh

WORLD = 8
K_FRACTION = 0.25


def _payload():
    rng = np.random.default_rng(0)
    grad = rng.standard_normal((16, 32)).astype(np.float32)
    memory = (0.1 * rng.standard_normal((16, 32))).astype(np.float32)
    return {
        "x": [torch.from_numpy(rng.standard_normal((6, 10)).astype(
            np.float32)) for _ in range(WORLD)],
        "vals": [torch.from_numpy(rng.standard_normal((16, 16)).astype(
            np.float32)) for _ in range(WORLD)],
        "mask": torch.from_numpy(rng.random((16, 16)) < 0.25),
        "grad": torch.from_numpy(grad), "memory": torch.from_numpy(memory),
        "k_fraction": K_FRACTION,
    }


@pytest.fixture(scope="module")
def ranks():
    if not dist.is_gloo_available():
        pytest.skip("torch.distributed has no gloo backend")
    from repro_torch.launch.mesh import run_ranks
    from tests import _torch_dist_ranks

    payload = _payload()
    return payload, run_ranks(_torch_dist_ranks.collectives, WORLD, payload)


def test_allreduce_mean_over_distinct_contributions(ranks):
    """Every rank gets the mean of the eight ranks' tensors over "data"
    of an (8, 1) mesh; over "model" of a (2, 4) mesh, the mean of its
    four model peers (ranks 4i .. 4i + 3)."""
    payload, res = ranks
    xs = np.stack([x.numpy() for x in payload["x"]])
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["mean_data"].numpy(), xs.mean(0),
                                   rtol=1e-6, atol=1e-7)
        lo = (r // 4) * 4
        np.testing.assert_allclose(out["mean_model"].numpy(),
                                   xs[lo:lo + 4].mean(0), rtol=1e-6,
                                   atol=1e-7)
        # the input is not written
        assert torch.equal(out["x_in"], payload["x"][r])


def test_fixed_mask_value_allreduce_equals_densified(ranks):
    """Under one shared mask the value-only exchange's dense form equals
    the paper's densify-allreduce-resparsify bitwise, and both equal the
    masked numpy mean."""
    payload, res = ranks
    mask = payload["mask"].numpy()
    want = np.stack([v.numpy() for v in payload["vals"]]).mean(0) * mask
    for out in res:
        assert torch.equal(out["fast"], out["dense"])
        np.testing.assert_allclose(out["dense"].numpy(), want, rtol=1e-6,
                                   atol=1e-7)


def test_compressed_allreduce_equals_the_reference(ranks):
    """Eight identical top-k payloads mean-reduced equal the reference's
    ``compressed_allreduce`` of that payload (a one-device mesh, so its
    mean is the payload itself) within rtol 1e-6, and the residual is the
    reference's bitwise."""
    payload, res = ranks
    g, mem = jnp.asarray(payload["grad"]), jnp.asarray(payload["memory"])
    (jv, ji), jmem = j_ef_step(g, mem, k_fraction=K_FRACTION)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with mesh:
        want = np.asarray(j_compressed(jv, ji, g.shape, mesh, "data"))
    for out in res:
        np.testing.assert_allclose(out["compressed"].numpy(), want,
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(out["memory"].numpy(),
                                      np.asarray(jmem))


def _ef_case(name):
    rng = np.random.default_rng(7)
    if name == "ties":
        # every magnitude repeated: lax.top_k takes the lower index first
        g = np.repeat(rng.integers(-4, 5, size=12), 4).astype(np.float32)
        return g.reshape(6, 8), np.zeros((6, 8), np.float32), 0.3
    g = rng.standard_normal((24, 40)).astype(np.float32)
    m = (0.3 * rng.standard_normal((24, 40))).astype(np.float32)
    return g, m, {"plain": 0.1, "one": 1e-6, "all": 1.0}[name]


@pytest.mark.parametrize("name", ["plain", "ties", "one", "all"])
def test_ef_step_equals_the_reference_bitwise(name):
    """``ef_step``'s payload (values and int32 indices, in ``lax.top_k``'s
    order) and residual equal the reference's bitwise: random values, a
    field of ties, k = 1 and k = everything."""
    g, m, frac = _ef_case(name)
    (jv, ji), jm = j_ef_step(jnp.asarray(g), jnp.asarray(m), k_fraction=frac)
    (tv, ti), tm = ef_step(torch.from_numpy(g), torch.from_numpy(m),
                           k_fraction=frac)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # the complement: payload scattered back plus the residual is g + m
    dense = np.zeros(g.size, np.float32)
    dense[ti.numpy()] = tv.numpy()
    np.testing.assert_array_equal(dense.reshape(g.shape) + tm.numpy(),
                                  g + m)


@pytest.mark.parametrize("model_parallel", [1, 2, 4, 8, 16])
def test_plan_remesh_equals_the_reference(model_parallel):
    """The remesh plan over surviving chip counts 0..64, ``ValueError``
    (with the reference's message) where the reference raises."""
    for n in range(0, 65):
        try:
            want = j_plan_remesh(n, model_parallel)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                plan_remesh(n, model_parallel)
            assert str(got.value) == str(e)
            continue
        assert plan_remesh(n, model_parallel) == want
