"""The port's ring attention (videoitg_tpu_torch/parallel/ring_attention.py)
over gloo ranks against the JAX package's `ring_attention` on the virtual CPU
mesh and against `mha_reference`, at tests/test_ring_attention.py's shapes and
tolerance (atol 3e-5, rtol 1e-4): rings of 4 (causal and not) and of 8, a key
mask whose last shard holds no valid key (dead rows), no valid key at all, and
flash blocks through kernel C's plain version. One world of 8 ranks, spawned
once, runs every case.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from _torch_dist import RING_CASES, ring_inputs, run_world
from videoitg_tpu.ops.attention import mha_reference
from videoitg_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from videoitg_tpu_torch.parallel import ring_attention as ring

TOL = dict(atol=3e-5, rtol=1e-4)
CASES = {c[0]: c for c in RING_CASES}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outs = run_world(8, "ring", tmp_path_factory.mktemp("ring"))
    return outs


def _jax_inputs(seed, shape, below):
    q, k, v, valid = ring_inputs(seed, *shape, valid_below=below)
    return (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if valid is None else jnp.asarray(valid))


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_jax_ring_and_reference(world, name):
    _, n, seed, shape, below, causal, impl = CASES[name]
    q, k, v, valid = _jax_inputs(seed, shape, below)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    want_ring = np.asarray(jax_ring_attention(q, k, v, valid=valid, mesh=mesh, causal=causal,
                                              block_impl=impl, interpret=True))
    want_ref = np.asarray(mha_reference(q, k, v, valid=valid, causal=causal))
    outs = [w[name] for w in world[:n]]
    for got in outs[1:]:  # every rank of the ring returns the same output
        np.testing.assert_array_equal(got, outs[0])
    got = outs[0]
    assert np.isfinite(got).all()
    rows = np.ones(got.shape[:3] + (1,), bool) if valid is None else \
        np.asarray(valid)[:, None, :, None]
    np.testing.assert_allclose(got * rows, want_ref * rows, **TOL)
    np.testing.assert_allclose(got, want_ring, **TOL)
    # invalid query rows are exact zeros (the flash-kernel contract)
    np.testing.assert_array_equal(got * ~rows, 0.0)


def test_mha_rings_under_an_sp_mesh(world):
    q, k, v, valid = _jax_inputs(21, (2, 4, 2, 128, 16), 100)
    want = np.asarray(mha_reference(q, k, v, valid=valid))
    rows = np.asarray(valid)[:, None, :, None]
    for w in world:
        np.testing.assert_allclose(w["mha-sp"] * rows, want * rows, **TOL)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_every_ranks_steps_in_one_process(impl):
    """`ring_shard` driven for every rank of a ring of 4 in one process, each
    rank fetching the next blocks from a list (how chip_smoke.py drives the
    kernel's steps), equals the unsplit attention; the last shard's keys
    are all masked."""
    q, k, v, valid = ring_inputs(5, 1, 4, 2, 64, 16, valid_below=40)
    n, s_loc = 4, 16
    qt, kt, vt, vd = (torch.from_numpy(a) for a in (q, k, v, valid))
    shards = [(kt[:, :, r * s_loc:(r + 1) * s_loc], vt[:, :, r * s_loc:(r + 1) * s_loc],
               vd[:, r * s_loc:(r + 1) * s_loc]) for r in range(n)]
    outs = []
    for r in range(n):
        def start(i, _blocks, r=r):
            return lambda: shards[(r + i + 1) % n]
        outs.append(ring.ring_shard(qt[:, :, r * s_loc:(r + 1) * s_loc], *shards[r], n=n,
                                    rank=r, start_fetch=start, block_impl=impl))
    got = torch.cat(outs, dim=2).numpy()
    want = np.asarray(mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    valid=jnp.asarray(valid)))
    rows = valid[:, None, :, None]
    np.testing.assert_allclose(got * rows, want * rows, **TOL)
    np.testing.assert_array_equal(got * ~rows, 0.0)
