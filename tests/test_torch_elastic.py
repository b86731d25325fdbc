"""Elastic restore: a checkpoint written by P workers restored at P' (port
of the reference's ``tests/test_elastic_restore.py``).

* The same content, P EF rows and P rows of thresholds, saved by each
  package and restored at P' (2 -> 1, 3 and 4, 4 -> 2, and 2 -> 2): the
  port's EF row is bit for bit the reference's restored row
  ``sum_p(rows) / P'`` (its ``jnp.sum`` over the rows, then the division),
  its thresholds the reference's ``jnp.mean`` of the rows, and at an
  unchanged width each rank keeps its own row. Into a padded (fused-EF)
  live row the first N entries are the same and the pad is zero.
* The port's checkpoints of P ranks are written here by one process that
  takes each rank's part in turn (``rank``/``world_size`` stood in), so no
  process group is needed; the files are those P processes write.
* A recurrent carry restarts from zeros at a new width; the params and the
  optimizer state restore as saved.
* A ``Trainer`` under ``--policy adaptive`` resumed at one worker from a
  checkpoint of two: ``on_elastic`` reaches ``reset_for_geometry``, the
  padded fused-EF row is the rows' sum with a zero pad, and the run trains
  on.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussiank_sgd_tpu.compressors import get_compressor as jget_compressor
from gaussiank_sgd_tpu.parallel.bucketing import plan_for_params \
    as jplan_for_params
from gaussiank_sgd_tpu.parallel.mesh import data_parallel_mesh
from gaussiank_sgd_tpu.parallel.trainstep import build_dp_train_step
from gaussiank_sgd_tpu.training import checkpoint as jck
from gaussiank_sgd_torch.parallel.trainstep import TrainState
from gaussiank_sgd_torch.training import checkpoint as ck
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.trainer import Trainer

NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]


def _ref_problem(n_dev):
    """The reference test's MLP on ``n_dev`` workers, with the stateful
    ``gaussian_warm`` (one bucket: thresholds ``[P, 1]``)."""
    import flax.linen as nn

    class M(nn.Module):
        @nn.compact
        def __call__(self, x, train=True):
            return nn.Dense(4)(nn.relu(nn.Dense(16)(x)))

    m = M()
    x = jax.random.normal(jax.random.PRNGKey(0), (16, 8))
    v = m.init({"params": jax.random.PRNGKey(0)}, x)

    def loss_fn(params, mstate, b, rng):
        logits = m.apply({"params": params}, b[0])
        return (optax.softmax_cross_entropy_with_integer_labels(
            logits, b[1]).mean(), (mstate, {}))

    mesh = data_parallel_mesh(n_dev)
    comp = jget_compressor("gaussian_warm", density=0.1)
    plan = jplan_for_params(v["params"], 0.1)
    ts = build_dp_train_step(loss_fn, optax.sgd(0.1), comp, plan, mesh)
    return ts, ts.init_state(v["params"], jax.random.PRNGKey(2))


def _content(p, n, seed):
    """P seeded EF rows (every magnitude, signs, exact zeros) and P rows of
    thresholds."""
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(p, n)) * 10.0 ** rng.integers(-6, 3, (p, n))
            ).astype(np.float32)
    rows[rng.random((p, n)) < 0.05] = 0.0
    thr = rng.uniform(0.01, 2.0, size=(p, 1)).astype(np.float32)
    return rows, thr


def _ref_restore(tmp_path, rows, thr, new_p):
    ts, st = _ref_problem(rows.shape[0])
    st = st._replace(
        ef_residual=jnp.asarray(rows.reshape(-1)),
        comp_state=jnp.asarray(thr).reshape(st.comp_state.shape))
    path = jck.save_checkpoint(str(tmp_path / "ref"), st,
                               num_workers=rows.shape[0])
    ts_n, st_n = _ref_problem(new_p)
    restored = jck.restore_checkpoint(path, st_n, ts_n.mesh)
    return (np.asarray(restored.ef_residual).reshape(new_p, -1),
            np.asarray(restored.comp_state))


def _port_save(monkeypatch, ckpt_dir, states):
    """Write one checkpoint as ``len(states)`` ranks would, rank r's part
    from ``states[r]``: rank 0 first (it makes the directory and writes the
    shared file), then the others, then the manifest over every file."""
    p = len(states)
    monkeypatch.setattr(ck, "world_size", lambda group=None: p)
    path = None
    for r, st in enumerate(states):
        monkeypatch.setattr(ck, "rank", lambda group=None, r=r: r)
        path = ck.save_checkpoint(ckpt_dir, st, st.params.numel(),
                                  overwrite=r > 0)
    ck._write_manifest(path, states[0].step, p)
    monkeypatch.undo()
    return path


def _port_state(n, ef, thr, step=3, params=None, carry=None):
    g = torch.Generator().manual_seed(1)
    return TrainState(
        step=step,
        params=(torch.randn(n, generator=g) if params is None
                else params.clone()),
        model_state={"stats": torch.zeros(2)},
        opt_state={"m": torch.arange(n, dtype=torch.float32)},
        ef_residual=torch.from_numpy(ef.copy()),
        comp_state=torch.from_numpy(thr.copy())[None, :], carry=carry)


@pytest.mark.parametrize("old_p,new_p,pad", [
    (2, 1, 0), (2, 3, 0), (2, 4, 0), (4, 2, 0), (2, 2, 0), (4, 3, 36)])
def test_restore_at_another_width_is_the_references(tmp_path, monkeypatch,
                                                    old_p, new_p, pad):
    n = 212                              # the reference MLP's parameters
    rows, thr = _content(old_p, n, seed=old_p * 10 + new_p)
    ref_rows, ref_thr = _ref_restore(tmp_path, rows, thr, new_p)
    path = _port_save(monkeypatch, str(tmp_path / "port"),
                      [_port_state(n, rows[r], thr[r])
                       for r in range(old_p)])
    seen = []
    for r in range(new_p):
        monkeypatch.setattr(ck, "world_size", lambda group=None: new_p)
        monkeypatch.setattr(ck, "rank", lambda group=None, r=r: r)
        live = _port_state(n + pad, np.zeros(n + pad, np.float32),
                           np.zeros(1, np.float32), step=0,
                           params=torch.zeros(n + pad))
        ck.restore_checkpoint(path, live, n + pad,
                              on_elastic=lambda a, b: seen.append((a, b)))
        monkeypatch.undo()
        ef = live.ef_residual.numpy()
        np.testing.assert_array_equal(ef[:n].view(np.int32),
                                      ref_rows[r].view(np.int32))
        assert not ef[n:].any()
        np.testing.assert_array_equal(
            live.comp_state[0].numpy().view(np.int32),
            ref_thr[r].view(np.int32))
        want = _port_state(n, rows[0], thr[0])
        assert torch.equal(live.params[:n], want.params)
        assert torch.equal(live.opt_state["m"][:n], want.opt_state["m"])
        assert live.step == 3
    if old_p == new_p:
        np.testing.assert_array_equal(ref_rows, rows)
        assert seen == []
    else:
        assert seen == [(old_p, new_p)] * new_p
        # mass preserving: P' rows of total / P'
        np.testing.assert_allclose(ref_rows.sum(0), rows.sum(0), rtol=1e-5,
                                   atol=1e-6 * np.abs(rows).max())


def test_recurrent_carry_restarts_from_zeros_at_a_new_width(tmp_path,
                                                            monkeypatch):
    n = 40
    rows, thr = _content(2, n, seed=5)
    carries = [torch.randn(1, 2, 3, 4) for _ in range(2)]
    path = _port_save(monkeypatch, str(tmp_path / "ck"),
                      [_port_state(n, rows[r], thr[r], carry=carries[r])
                       for r in range(2)])
    # the same width: each rank gets its own carry back
    for r in range(2):
        monkeypatch.setattr(ck, "world_size", lambda group=None: 2)
        monkeypatch.setattr(ck, "rank", lambda group=None, r=r: r)
        live = _port_state(n, np.zeros(n, np.float32),
                           np.zeros(1, np.float32), step=0,
                           carry=torch.ones(1, 2, 3, 4))
        ck.restore_checkpoint(path, live, n)
        monkeypatch.undo()
        assert torch.equal(live.carry, carries[r])
    # another width: the carry (its rows are batch rows of the old layout)
    # restarts from zeros in the live shape; the rest restores
    monkeypatch.setattr(ck, "world_size", lambda group=None: 1)
    monkeypatch.setattr(ck, "rank", lambda group=None: 0)
    live = _port_state(n, np.zeros(n, np.float32), np.zeros(1, np.float32),
                       step=0, carry=torch.ones(1, 2, 6, 4))
    ck.restore_checkpoint(path, live, n)
    monkeypatch.undo()
    assert live.carry.shape == (1, 2, 6, 4) and not live.carry.any()
    assert torch.equal(live.ef_residual, torch.from_numpy(rows[0])
                       + torch.from_numpy(rows[1]))
    assert torch.equal(live.params, _port_state(n, rows[0], thr[0]).params)


def test_trainer_resumed_at_another_worker_count(tmp_path, monkeypatch):
    """A padded fused-EF run's state written as two ranks' checkpoint (two
    different EF rows), resumed by an adaptive ``Trainer`` at one worker:
    the engine's geometry signals are dropped, the EF row is the rows'
    sum in the unpadded space with a zero pad, the thresholds their mean,
    and the run trains on to a finite loss."""
    def cfg(run_id, **kw):
        return TrainConfig(dnn="vgg16", batch_size=16, nworkers=1,
                           compressor="gaussian_fused", density=0.01,
                           compress_warmup_steps=2, max_steps=8,
                           log_every=2, lr=0.05, compute_dtype="float32",
                           device="cpu", model_kwargs={"cfg": NARROW},
                           output_dir=str(tmp_path), run_id=run_id,
                           eval_every_epochs=0, save_every_epochs=0,
                           policy="adaptive", **kw)

    t = Trainer(cfg("a"))
    t.train(4)
    n, padded = t.plan.total_numel, t.ts.ef_numel
    assert padded > n
    st = t.state
    other = TrainState(step=st.step, params=st.params.detach(),
                       model_state=st.model_state, opt_state=st.opt_state,
                       ef_residual=st.ef_residual * 0.5 - 1e-3,
                       comp_state=st.comp_state * 2.0)
    other.ef_residual[n:] = 0.0
    rows = [st.ef_residual[:n].clone(), other.ef_residual[:n].clone()]
    thr = [st.comp_state[0].clone(), other.comp_state[0].clone()]
    path = _port_save(monkeypatch, str(tmp_path / "ckpt"), [st, other])
    t.close()

    geometry = []
    real = Trainer._on_elastic_restore

    def noting(self, old_p, new_p):
        reset = self.engine.signals.reset_for_geometry
        self.engine.signals.reset_for_geometry = (
            lambda p: geometry.append(p) or reset(p))
        real(self, old_p, new_p)

    monkeypatch.setattr(Trainer, "_on_elastic_restore", noting)
    r = Trainer(cfg("b", resume=os.path.dirname(path)))
    assert geometry == [1] and r.step == 4
    ef = r.state.ef_residual
    assert ef.numel() == padded and not ef[n:].any()
    assert torch.equal(ef[:n], rows[0] + rows[1])
    assert torch.equal(r.state.comp_state[0], (thr[0] + thr[1]) / 2)
    r.train(4)
    assert r.step == 8 and np.isfinite(r.records[-1]["loss"])
    r.close()
