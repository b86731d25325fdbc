"""The port's ring attention (``parallel/ring_attention.py``) against full
softmax attention and against the reference's ring on its 8-device CPU
mesh, on the same numpy-seeded inputs.

* Over gloo at sp = 2 and 4 (one process a block of the sequence), causal
  and not: each rank's output block, and the gradients of ``sum(out * w)``
  with respect to its q, k and v blocks (the hop's backward sends them
  back round the ring), within the reference test's rtol 2e-4 / atol
  2e-5 of full attention and of the reference's ring
  (``tests/test_ring_attention.py:33``).
* sp = 1 (no process group) is local attention; T = 512 over sp = 4 (3
  hops) still equals full attention.
* The hop's host staging (a CUDA block on a gloo group) runs the same ring
  when forced on the CPU, and is taken for no CPU tensor.
* ``ring_attention_blocks``, the one-process simulation ``chip_smoke.py``
  runs on the card, equals full attention at sp = 2, 4 and 8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from gaussiank_sgd_tpu.compat import shard_map
from gaussiank_sgd_tpu.parallel.ring_attention import (
    ring_attention as jring_attention)
from gaussiank_sgd_torch.parallel.ring_attention import (ring_attention,
                                                         ring_attention_blocks)
from test_torch_distributed import _spawn

TOL = dict(rtol=2e-4, atol=2e-5)


def _qkvw(b, h, t, d, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=(b, h, t, d))).astype(np.float32)
            for _ in range(4)]


def full_attention(q, k, v, causal):
    """The reference test's oracle, in f32 numpy-backed JAX."""
    d = q.shape[-1]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k).astype(jnp.float32) * d ** -0.5
    if causal:
        t = s.shape[-1]
        s = jnp.where(jnp.tril(jnp.ones((t, t), bool))[None, None], s,
                      -jnp.inf)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1),
                      v.astype(jnp.float32))


def _reference(q, k, v, w, causal, sp):
    """The reference's ring on ``sp`` CPU devices: the output and the
    gradients of ``sum(out * w)``."""
    mesh = Mesh(np.asarray(jax.devices()[:sp]), ("sp",))
    ring = shard_map(functools.partial(jring_attention, axis_name="sp",
                                       causal=causal),
                     mesh=mesh, in_specs=(P(None, None, "sp"),) * 3,
                     out_specs=P(None, None, "sp"), check_vma=False)
    out = jax.jit(ring)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) * w),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _w_ring(rank, world, q, k, v, w, causal, force_stage):
    """One rank of the ring: its blocks of q, k, v and w (dim 2 split over
    the world); the output block and the gradients of ``sum(out * w)``,
    and how often the hop staged through host memory."""
    import torch
    from gaussiank_sgd_torch.parallel import collectives
    from gaussiank_sgd_torch.parallel import ring_attention as ra
    staged = []
    if force_stage:
        collectives.host_staged = lambda x, group=None: (
            staged.append(1) or True)
    t = q.shape[2] // world

    def block(a):
        return torch.from_numpy(a[:, :, rank * t:(rank + 1) * t].copy())

    qb, kb, vb = (block(a).requires_grad_() for a in (q, k, v))
    out = ra.ring_attention(qb, kb, vb, None, causal=causal)
    (out * block(w)).sum().backward()
    return {"out": out.detach().numpy(),
            "grads": [x.grad.numpy() for x in (qb, kb, vb)],
            "staged": len(staged)}


def _gathered(outs, key):
    if key == "out":
        return np.concatenate([o["out"] for o in outs], axis=2)
    return [np.concatenate([o["grads"][i] for o in outs], axis=2)
            for i in range(3)]


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_over_gloo_matches_full_attention_and_the_reference(
        tmp_path, sp, causal):
    q, k, v, w = _qkvw(2, 4, 64, 16, seed=sp + 10 * causal)
    outs = _spawn(tmp_path, sp, _w_ring, q=q, k=k, v=v, w=w, causal=causal,
                  force_stage=False)
    out, grads = _gathered(outs, "out"), _gathered(outs, "grads")
    np.testing.assert_allclose(out, np.asarray(full_attention(q, k, v,
                                                              causal)), **TOL)
    full_grads = jax.grad(lambda q, k, v: jnp.sum(
        full_attention(q, k, v, causal) * w), argnums=(0, 1, 2))(q, k, v)
    jout, jgrads = _reference(q, k, v, w, causal, sp)
    np.testing.assert_allclose(out, jout, **TOL)
    for g, jg, fg in zip(grads, jgrads, full_grads):
        np.testing.assert_allclose(g, jg, **TOL)
        np.testing.assert_allclose(g, np.asarray(fg), **TOL)
    assert all(o["staged"] == 0 for o in outs)


def test_ring_single_shard_degenerates_to_local():
    """sp = 1: no hop, local attention (no process group needed)."""
    q, k, v, _ = _qkvw(1, 2, 32, 8, seed=3)
    out = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)), None,
                         causal=True)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(full_attention(q, k, v, True)),
                               **TOL)


def test_ring_long_context_512(tmp_path):
    """T = 512 over sp = 4: 128 positions resident a rank, 3 K/V hops,
    still full attention (the reference holds its sp = 8 run at rtol 3e-4
    / atol 3e-5)."""
    q, k, v, w = _qkvw(1, 2, 512, 16, seed=5, scale=0.5)
    outs = _spawn(tmp_path, 4, _w_ring, q=q, k=k, v=v, w=w, causal=True,
                  force_stage=False)
    np.testing.assert_allclose(_gathered(outs, "out"),
                               np.asarray(full_attention(q, k, v, True)),
                               rtol=3e-4, atol=3e-5)


def test_the_hops_host_staging_runs_the_same_ring(tmp_path):
    """The staging path (taken for a CUDA block on a gloo group) forced on
    the CPU: each rank stages every forward and backward hop (2 + 2 at sp
    = 3) and the result equals the unstaged ring's; a CPU tensor is never
    staged."""
    from gaussiank_sgd_torch.parallel.collectives import host_staged
    assert not host_staged(torch.zeros(1))
    q, k, v, w = _qkvw(1, 2, 48, 8, seed=7)
    staged = _spawn(tmp_path, 3, _w_ring, q=q, k=k, v=v, w=w, causal=True,
                    force_stage=True)
    plain = _spawn(tmp_path, 3, _w_ring, q=q, k=k, v=v, w=w, causal=True,
                   force_stage=False)
    assert [o["staged"] for o in staged] == [4, 4, 4]
    for a, b in zip(staged, plain):
        np.testing.assert_array_equal(a["out"], b["out"])
        for ga, gb in zip(a["grads"], b["grads"]):
            np.testing.assert_array_equal(ga, gb)


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_process_ring_matches_full_attention(sp, dtype):
    """``ring_attention_blocks``: every rank of an sp ring in one process,
    in f32 and bf16 inputs (the ring accumulates in f32 and returns the
    input's dtype), against full attention on the same (rounded)
    inputs."""
    q, k, v, _ = _qkvw(2, 2, 64, 16, seed=sp)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    outs = ring_attention_blocks(tq.chunk(sp, dim=2), tk.chunk(sp, dim=2),
                                 tv.chunk(sp, dim=2), causal=True)
    assert all(o.dtype == dtype for o in outs)
    want = full_attention(*(np.asarray(a.float()) for a in (tq, tk, tv)),
                          True)
    got = torch.cat(outs, dim=2).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    else:
        np.testing.assert_allclose(
            got, np.asarray(jnp.asarray(want).astype(jnp.bfloat16)
                            .astype(jnp.float32)), rtol=2 ** -7, atol=1e-5)
