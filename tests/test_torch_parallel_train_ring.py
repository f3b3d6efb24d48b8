"""The port's differentiable ring attention (`ring_attention_train`,
videoitg_tpu_torch/parallel/ring_attention.py) over gloo ranks against
`jax.grad` of the JAX package's `ring_attention_train` on the virtual CPU
mesh (Pallas in interpret mode), as tests/test_ring_attention.py builds it:
rings of 2 and 4 over a key mask whose last block holds no valid key, a loss
that reads only the valid query rows; dq, dk, dv and the output at atol 2e-5.
The forward equals the serving flash ring; `mha(use_flash="train")` under an
sp mesh rings. One world of 4 ranks, spawned once, runs every case. Every
rank's backward steps (`ring_shard_backward`, the plain versions of kernels
D and E) driven in one process equal autograd through the unsplit attention.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from _torch_dist import ring_train_inputs, run_world
from videoitg_tpu.parallel.ring_attention import ring_attention_train as jax_ring_train
from videoitg_tpu_torch.ops.attention import mha_reference
from videoitg_tpu_torch.parallel import ring_attention as ring

ATOL = 2e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(4, "ring_train", tmp_path_factory.mktemp("ring_train"))


@functools.lru_cache(maxsize=None)
def _jax_grads(n):
    q, k, v, valid = ring_train_inputs(n, n)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    rows = jnp.asarray(valid)[:, None, :, None].astype(jnp.float32)

    def loss(q_, k_, v_):
        out = jax_ring_train(q_, k_, v_, valid=jnp.asarray(valid), mesh=mesh, axis="sp",
                             interpret=True)
        return jnp.sum((out.astype(jnp.float32) * rows) ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return valid, np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [2, 4])
def test_ring_train_gradients_match_jax(world, n):
    valid, want_out, want = _jax_grads(n)
    rows = valid[:, None, :, None]
    for r in range(n):
        out, *grads = world[r][f"sp{n}"]
        np.testing.assert_allclose(out * rows, want_out * rows, atol=ATOL)
        np.testing.assert_array_equal(out * ~rows, 0.0)
        for name, got, exp in zip(("dq", "dk", "dv"), grads, want):
            assert np.isfinite(got).all(), name
            np.testing.assert_allclose(got, exp, atol=ATOL, err_msg=f"rank {r} {name}")
    # every rank holds the same activation gradients (gathered over sp)
    for r in range(1, n):
        for a, b in zip(world[r][f"sp{n}"], world[0][f"sp{n}"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_train_forward_equals_the_serving_ring(world, n):
    for r in range(n):
        np.testing.assert_allclose(world[r][f"sp{n}"][0], world[r][f"sp{n}-serving"],
                                   atol=1e-6)


def test_mha_train_dispatch_rings_under_an_sp_mesh(world):
    _, _, want = _jax_grads(4)
    for r in range(4):
        np.testing.assert_array_equal(world[r]["mha-sp4"][0], world[r]["sp4"][0])
        for got, exp in zip(world[r]["mha-sp4"][1:], want):
            np.testing.assert_allclose(got, exp, atol=ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_every_ranks_backward_in_one_process(n):
    """Each rank's forward and backward ring driven in one process, blocks
    fetched from a list and each rank's dK/dV contributions recorded where
    the ring would pass them on, equals autograd through the unsplit plain
    attention; the last block has no valid key and no valid row."""
    q, k, v, valid = (torch.from_numpy(a) for a in ring_train_inputs(n, n))
    s_loc = q.shape[2] // n
    part = [slice(r * s_loc, (r + 1) * s_loc) for r in range(n)]
    shards = [(k[:, :, p].contiguous(), v[:, :, p].contiguous(), valid[:, p].contiguous())
              for p in part]
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    rows = valid[:, None, :, None].float()
    out = mha_reference(qa, ka, va, valid=valid)
    ((out * rows) ** 2).sum().backward()
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    dqs = []
    for r in range(n):
        def fetch(i, _blocks, r=r):
            return lambda: shards[(r + i + 1) % n]
        q_l = q[:, :, part[r]].contiguous()
        lse, acc = ring.ring_flash_state(q_l, *shards[r], n=n, start_fetch=fetch)
        o_l = ring.finish(acc, shards[r][2], q.dtype)
        do_l = 2 * o_l * rows[:, :, part[r]]
        sent = []

        def pass_grads(dk_acc, dv_acc, sent=sent):
            sent.append((dk_acc, dv_acc))  # the block in hand: (r + len(sent) - 1) % n
            return torch.zeros_like(dk_acc), torch.zeros_like(dv_acc)
        dq_l, _, _ = ring.ring_shard_backward(q_l, *shards[r], o_l, lse, do_l, n=n,
                                              start_fetch=fetch, pass_grads=pass_grads)
        assert len(sent) == n
        for i, (dk_i, dv_i) in enumerate(sent):
            blk = part[(r + i) % n]
            dk[:, :, blk] += dk_i
            dv[:, :, blk] += dv_i
        dqs.append(dq_l)
    for name, got, want in (("dq", torch.cat(dqs, dim=2), qa.grad), ("dk", dk, ka.grad),
                            ("dv", dv, va.grad)):
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, err_msg=name)
