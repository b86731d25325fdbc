"""Checkpoint and resume of the port (``training/checkpoint.py`` and the
trainer's save, resume and epoch loop).

* A narrow VGG with dropout on (so the dropout generator's state counts)
  saves at step 4, and a fresh ``Trainer`` resumed from that step continues
  the uninterrupted run bit for bit: every loss, then the parameters,
  momentum, EF row, thresholds and BatchNorm statistics. The same at P = 2
  over gloo, on every rank.
* A P = 2 checkpoint restored at P = 1 gives the one EF row ``row0 +
  row1`` bit for bit, which is the reference's ``jnp.sum(rows, 0) / 1`` on
  the same rows, and the thresholds the mean of the rows (``jnp.mean``).
* The fused-EF pad never reaches the disk (rows of N on disk) and is zero
  after a restore.
* Unsealed directories are skipped, a sealed one whose bytes were damaged
  falls back to the one before, ``gc_checkpoints`` keeps the last k, and a
  resumed run that reaches a step an older trajectory sealed overwrites it.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussiank_sgd_torch.parallel.trainstep import TrainState
from gaussiank_sgd_torch.training import checkpoint as ck
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.trainer import Trainer
from test_torch_distributed import _spawn

NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]


def _cfg(out_dir, run_id, nworkers=1, **kw):
    """Narrow VGG (dropout 0.5) on synthetic CIFAR, 2 dense then sparse
    gaussian_fused steps, a checkpoint every 4 steps; the resume stays in
    the first epoch, where the reference's stream repeats its augmentation
    draws exactly (``data/loader.py:EpochStream``)."""
    base = dict(dnn="vgg16", batch_size=16, nworkers=nworkers,
                compressor="gaussian_fused", density=0.01,
                compress_warmup_steps=2, max_steps=8, save_every_steps=4,
                eval_max_batches=2, lr=0.05, compute_dtype="float32",
                device="cpu", model_kwargs={"cfg": NARROW},
                output_dir=str(out_dir), run_id=run_id)
    return TrainConfig(**{**base, **kw})


def _snapshot(t):
    st = t.state
    return {"params": st.params.detach().clone(),
            "momentum": st.opt_state["m"].clone(),
            "EF row": st.ef_residual.clone(),
            "thresholds": st.comp_state.clone(),
            "stats": t.model.stats.clone()}


def test_resume_continues_bit_for_bit(tmp_path):
    t = Trainer(_cfg(tmp_path, "a"))
    assert t.model.dropout > 0 and t.ts.fused_ef is not None
    t.fit()
    losses = [r["loss"] for r in t.records]
    want = _snapshot(t)
    assert [s for s, _ in ck.list_checkpoints(t.ckpt_dir)] == [4, 8]
    events = [e for e in map(json.loads, (tmp_path / "a" / "metrics.jsonl")
                             .read_text().splitlines())
              if e["event"] in ("checkpoint", "eval")]
    # step 8's save comes from the step cadence, before the epoch's eval;
    # the epoch-end and final saves of step 8 are then no-ops
    assert [(e["event"], e["step"]) for e in events] == [
        ("checkpoint", 4), ("checkpoint", 8), ("eval", 8)]
    assert events[0]["bytes"] == ck.checkpoint_bytes(
        os.path.join(t.ckpt_dir, "step_00000004"))

    r = Trainer(_cfg(tmp_path, "b",
                     resume=os.path.join(t.ckpt_dir, "step_00000004")))
    assert r.state.step == 4
    r.fit()
    assert [x["loss"] for x in r.records] == losses[4:]
    for key, v in _snapshot(r).items():
        assert torch.equal(v, want[key]), key

    # the pad never reaches the disk and is zero after the restore
    n, n_pad = r.plan.total_numel, r.ts.ef_numel
    assert n_pad > n
    row = torch.load(os.path.join(t.ckpt_dir, "step_00000004",
                                  "rank_00000.pt"), weights_only=True)
    shared = torch.load(os.path.join(t.ckpt_dir, "step_00000004",
                                     "state.pt"), weights_only=True)
    assert row["ef_residual"].shape == shared["params"].shape == (n,)
    assert row["dropout_generator"] is not None
    for v in (r.state.params, r.state.opt_state["m"], r.state.ef_residual):
        assert v.shape == (n_pad,) and not v[n:].any()


def test_resume_from_older_step_overwrites_its_sealed_successor(tmp_path):
    """The trajectory rule: a run resumed at step 4 in the same run
    directory, with another lr, re-reaches step 8, which the first
    trajectory sealed; its own state replaces that directory's."""
    Trainer(_cfg(tmp_path, "a")).fit()
    ckpt = tmp_path / "a" / "ckpt"
    first = torch.load(ckpt / "step_00000008" / "state.pt",
                       weights_only=True)["params"]
    t = Trainer(_cfg(tmp_path, "a", lr=0.01,
                     resume=str(ckpt / "step_00000004")))
    t.fit()
    again = torch.load(ckpt / "step_00000008" / "state.pt",
                       weights_only=True)["params"]
    assert not torch.equal(first, again)
    assert torch.equal(again, t.state.params.detach()[:t.plan.total_numel])
    # a second save of a step this trajectory saved is a no-op
    stamp = json.loads((ckpt / "step_00000008" / ck.MANIFEST).read_text())
    t.save_checkpoint()
    assert json.loads((ckpt / "step_00000008" / ck.MANIFEST).read_text()
                      ) == stamp


def _tiny_state(step, seed=0):
    g = torch.Generator().manual_seed(seed)
    return TrainState(step=step, params=torch.randn(12, generator=g),
                      model_state={"stats": torch.randn(3, generator=g)},
                      opt_state={"m": torch.randn(12, generator=g)},
                      ef_residual=torch.randn(12, generator=g),
                      comp_state=torch.rand(1, 2, generator=g))


def test_sealing_fallback_and_gc(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3):
        ck.save_checkpoint(d, _tiny_state(step, seed=step), 10)
    # an aborted save: files but no manifest
    os.makedirs(os.path.join(d, "step_00000004"))
    (tmp_path / "ckpt" / "step_00000004" / "state.pt").write_bytes(b"x")
    assert [s for s, _ in ck.list_checkpoints(d)] == [1, 2, 3]
    assert ck.latest_checkpoint(d).endswith("step_00000003")
    # bit rot in a sealed checkpoint: same size, so still listed, but the
    # restore fails its CRC and falls back to step 2
    rot = tmp_path / "ckpt" / "step_00000003" / "rank_00000.pt"
    b = bytearray(rot.read_bytes())
    b[len(b) // 2] ^= 0xFF
    rot.write_bytes(bytes(b))
    assert ck.is_committed(str(rot.parent))
    skipped = []
    target = _tiny_state(0, seed=9)
    path = ck.restore_latest_good(d, target, 12,
                                  on_skip=lambda p, e: skipped.append(p))
    assert path.endswith("step_00000002") and len(skipped) == 1
    want = _tiny_state(2, seed=2)
    assert target.step == 2
    assert torch.equal(target.params[:10], want.params[:10])
    assert not target.params[10:].any() and not target.ef_residual[10:].any()
    assert torch.equal(target.ef_residual[:10], want.ef_residual[:10])
    assert torch.equal(target.comp_state, want.comp_state)
    # a truncated file unseals its checkpoint
    (tmp_path / "ckpt" / "step_00000001" / "state.pt").write_bytes(b"")
    assert [s for s, _ in ck.list_checkpoints(d)] == [2, 3]
    assert ck.gc_checkpoints(d, 1) == [os.path.join(d, "step_00000002")]
    assert [s for s, _ in ck.list_checkpoints(d)] == [3]
    assert os.path.isdir(os.path.join(d, "step_00000004"))  # left alone
    with pytest.raises(RuntimeError, match="every committed"):
        ck.restore_latest_good(d, target, 12)
    with pytest.raises(FileNotFoundError):
        ck.restore_latest_good(str(tmp_path / "none"), target, 12)


def _w_ckpt(rank, world, cfg_kw):
    from gaussiank_sgd_torch.training.config import TrainConfig
    from gaussiank_sgd_torch.training.trainer import Trainer
    t = Trainer(TrainConfig(**cfg_kw))
    t.fit()
    losses = [r["loss"] for r in t.records]
    resume = os.path.join(t.ckpt_dir, "step_00000004")
    r = Trainer(TrainConfig(**{**cfg_kw, "run_id": "resumed",
                               "resume": resume}))
    r.fit()
    resumed = [x["loss"] for x in r.records]

    def state(tr):
        st = tr.state
        return [st.params.detach().numpy().copy(),
                st.opt_state["m"].numpy().copy(),
                st.ef_residual.numpy().copy(), st.comp_state.numpy().copy(),
                tr.model.stats.numpy().copy()]
    return {"losses": losses, "resumed": resumed, "state": state(t),
            "resumed_state": state(r), "ckpt": t.ckpt_dir}


def test_two_workers_resume_and_restore_at_one(tmp_path):
    kw = _cfg(tmp_path, "p2", nworkers=2, batch_size=8).__dict__
    outs = _spawn(tmp_path, 2, _w_ckpt, cfg_kw=kw)
    for o in outs:
        assert o["resumed"] == o["losses"][4:]
        for a, b in zip(o["state"], o["resumed_state"]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(outs[0]["state"][:2], outs[1]["state"][:2]):
        np.testing.assert_array_equal(a, b)           # replicated
    assert not np.array_equal(outs[0]["state"][2], outs[1]["state"][2])

    # P = 2 -> 1: one row, row0 + row1; thresholds the rows' mean
    path = os.path.join(outs[0]["ckpt"], "step_00000008")
    rows = [torch.load(os.path.join(path, f"rank_{r:05d}.pt"),
                       weights_only=True) for r in range(2)]
    one = Trainer(_cfg(tmp_path, "p1", batch_size=16, resume=path))
    n = one.plan.total_numel
    ef = one.state.ef_residual
    want = rows[0]["ef_residual"] + rows[1]["ef_residual"]
    assert torch.equal(ef[:n], want) and not ef[n:].any()
    stacked = np.stack([row["ef_residual"].numpy() for row in rows])
    np.testing.assert_array_equal(
        ef[:n].numpy(), np.asarray(jnp.sum(jnp.asarray(stacked), 0) / 1))
    thr = np.stack([row["comp_state"].numpy() for row in rows])
    np.testing.assert_array_equal(one.state.comp_state[0].numpy(),
                                  np.asarray(jnp.mean(jnp.asarray(thr), 0)))
    np.testing.assert_array_equal(one.state.params.detach().numpy(),
                                  outs[0]["state"][0])
    assert one.state.step == 8
