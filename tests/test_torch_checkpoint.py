"""The port's checkpointing and fault tolerance
(``repro_torch.distributed``) and the checkpointed ``fit``, on the CPU.

The manager keeps the reference's on-disk layout (``step_XXXXXXXX/``
holding ``arrays.npz`` and ``manifest.json``), so a checkpoint written
by either package restores in the other, value for value.  The port's
``TrainSupervisor`` runs the same numpy step function and fault hook as
the reference's and must give the same report, final state and saved
steps (exactly: the state is small integers and floats).  A CPU ``fit``
killed at an epoch and re-invoked with the same seed equals the
uninterrupted fit bit for bit.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import CheckpointManager as RefCheckpointManager
from repro.distributed import HeartbeatMonitor as RefHeartbeatMonitor
from repro.distributed import TrainSupervisor as RefTrainSupervisor
from repro_torch.configs import ICQConfig
from repro_torch.data import guyon_dataset
from repro_torch.distributed import (CheckpointManager, HeartbeatMonitor,
                                     SupervisorReport, TrainSupervisor,
                                     flatten_pytree, unflatten_pytree)
from repro_torch.trainer import fit


def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros((4,))},
            "step": torch.tensor(int(v), dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    """Tensors go to host numpy and come back with the template's
    dtype, shape and device."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(10, _state(3.0))
    step, restored = mgr.restore_latest(_state())
    assert step == 10
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 3
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 3.0))
    assert sorted(os.listdir(tmp_path / "step_00000010")) == [
        "arrays.npz", "manifest.json"]


def test_checkpoint_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for i in range(5):
        mgr.save(i, _state(float(i)))
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_keep_period(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, keep_period=2)
    for i in range(5):
        mgr.save(i, _state(float(i)))
    assert set(mgr.all_steps()) == {0, 2, 4}


def test_corrupt_latest_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1.0))
    mgr.save(2, _state(2.0))
    with open(os.path.join(str(tmp_path), "step_00000002", "arrays.npz"),
              "wb") as f:
        f.write(b"garbage")
    step, restored = mgr.restore_latest(_state())
    assert step == 1
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 1.0))


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(7, _state(7.0))
    mgr.wait()
    assert mgr.all_steps() == [7]


def test_checkpoints_cross_packages(tmp_path):
    """A checkpoint of either package restores in the other (the
    reference's template a jax/numpy tree, the port's a torch tree);
    ``flatten_pytree`` gives the reference's keys, ``None`` skipped."""
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    CheckpointManager(port_dir).save(4, _state(4.0))
    ref_tmpl = {"params": {"w": jnp.zeros((4, 4)), "b": jnp.zeros((4,))},
                "step": jnp.asarray(0, jnp.int32)}
    step, got = RefCheckpointManager(port_dir).restore_latest(ref_tmpl)
    assert step == 4
    np.testing.assert_array_equal(np.asarray(got["params"]["w"]),
                                  np.full((4, 4), 4.0))
    RefCheckpointManager(ref_dir).save(
        5, {"params": {"w": jnp.full((4, 4), 5.0), "b": jnp.ones((4,))},
            "step": jnp.asarray(5, jnp.int32)})
    step, got = CheckpointManager(ref_dir).restore_latest(_state())
    assert step == 5 and int(got["step"]) == 5
    assert torch.equal(got["params"]["b"], torch.ones(4))
    flat = flatten_pytree({"base": None, "R": torch.eye(2),
                           "l": [torch.zeros(1), {"z": 1.0}]})
    assert sorted(flat) == ["R", "l/0", "l/1/z"]
    back = unflatten_pytree({"R": torch.zeros(2, 2),
                             "l": [torch.ones(1), {"z": np.float32(0)}]},
                            flat)
    assert torch.equal(back["R"], torch.eye(2))
    assert back["l"][1]["z"].dtype == np.float32


# ------------------------------------------------------------- supervisor --

def _scenario(name):
    """(run kwargs, fault_hook factory, step function, steps, a
    checkpoint to plant first) of one supervisor scenario; the step
    functions are numpy-only, so both packages run the same code."""
    def inc(state, idx):
        return ({"params": {"w": state["params"]["w"] + 1.0},
                 "step": np.asarray(idx)}, {"loss": 1.0})

    def nan_at_3(state, idx):
        return ({"params": {"w": state["params"]["w"] + 1.0},
                 "step": np.asarray(idx)},
                {"loss": float("nan") if idx == 3 else 0.5})

    def once_at(step):
        def factory():
            crashed = {"done": False}

            def hook(s):
                if s == step and not crashed["done"]:
                    crashed["done"] = True
                    raise RuntimeError("simulated node loss")
            return hook
        return factory

    def always():
        def hook(s):
            raise RuntimeError("permanent node loss")
        return hook

    table = {
        "restart": (dict(save_every=2), once_at(5), inc, 8, None),
        "restart-before-any-save": (dict(save_every=2), once_at(1), inc, 4,
                                    None),
        "nan": (dict(save_every=100), None, nan_at_3, 6, None),
        "resume": (dict(save_every=100), None, inc, 6, 3),
        "exhausted": (dict(save_every=1, max_restarts=2), always, inc, 4,
                      None),
        "final-save": (dict(save_every=100), None, inc, 3, None),
    }
    return table[name]


@pytest.mark.parametrize("name", ["restart", "restart-before-any-save",
                                  "nan", "resume", "exhausted",
                                  "final-save"])
def test_supervisor_matches_reference(tmp_path, name):
    """The same numpy step function and fault hook under both
    supervisors: the same report (or the same exception after the same
    attempts), final state and saved steps."""
    kw, hook_factory, step_fn, steps, plant = _scenario(name)
    outcomes = []
    for Mgr, Sup in ((RefCheckpointManager, RefTrainSupervisor),
                     (CheckpointManager, TrainSupervisor)):
        mgr = Mgr(str(tmp_path / Sup.__module__), keep=10)
        if plant is not None:
            mgr.save(plant, {"params": {"w": np.asarray(42.0)},
                             "step": np.asarray(plant)})
        attempts = {"n": 0}
        hook = hook_factory() if hook_factory else None

        def counted(s, hook=hook):
            attempts["n"] += 1
            if hook is not None:
                hook(s)
        sup = Sup(mgr, async_save=False, **kw)
        state0 = {"params": {"w": np.asarray(0.0)}, "step": np.asarray(0)}
        try:
            state, rep = sup.run(state0, step_fn, steps, fault_hook=counted)
            out = (float(state["params"]["w"]), rep.final_step,
                   rep.restarts, rep.nan_skips, rep.resumed_from)
        except RuntimeError as e:
            out = ("raised", str(e))
        outcomes.append((out, attempts["n"], mgr.all_steps()))
    assert outcomes[1] == outcomes[0]
    if name != "exhausted":
        assert isinstance(rep, SupervisorReport)


def test_heartbeat_matches_reference():
    """Stragglers, the fleet median, the window and dead hosts as the
    reference's monitor reports them for the same beats."""
    mons = [cls(num_hosts=4, straggler_factor=3.0, dead_after=10.0,
                window=8) for cls in (RefHeartbeatMonitor, HeartbeatMonitor)]
    for mon in mons:
        assert mon.stragglers() == [] and mon.fleet_median() == 0.0
        for step in range(20):
            for h in range(3):
                mon.beat(h, 1.0 if h != 2 else 5.0 + step,
                         now=1000.0 + step)
        mon.beat(3, 1.0, now=900.0)
    (ref, port) = mons
    assert port.stragglers() == ref.stragglers() == [2]
    assert port.fleet_median() == ref.fleet_median()
    assert port.dead(now=1020.0) == ref.dead(now=1020.0) == [3]
    assert len(port._latency[2]) == 8


# ----------------------------------------------------------- fit(ckpt_dir) --

CFG = dict(d=8, num_codebooks=4, codebook_size=16, num_fast=1)
KW = dict(epochs=4, batch_size=128, device="cpu")


@pytest.fixture(scope="module")
def guyon():
    return guyon_dataset(512, 32, 12, 10, seed=5)


@pytest.fixture(scope="module")
def uninterrupted(guyon):
    xs, ys = guyon
    return fit(7, xs, ys, ICQConfig(**CFG), **KW)


def _same_model(a, b):
    assert torch.equal(a.C, b.C) and torch.equal(a.codes, b.codes)
    for got, want in zip(a.structure, b.structure):
        assert torch.equal(got, want)
    assert torch.equal(a.lam, b.lam)


def test_fit_killed_and_resumed_equals_uninterrupted(guyon, uninterrupted,
                                                     tmp_path):
    """``fit(ckpt_dir=)`` killed at epoch 2 (the fault propagates: no
    restarts left), then re-invoked with the same seed: it resumes from
    the epoch-1 checkpoint and ends bit for bit where the uninterrupted
    fit ends (C, codes, structure, lam)."""
    xs, ys = guyon
    ckpt = str(tmp_path / "ckpt")

    def kill(epoch):
        if epoch == 2:
            raise RuntimeError("killed")
    with pytest.raises(RuntimeError, match="killed"):
        fit(7, xs, ys, ICQConfig(**CFG), ckpt_dir=ckpt, max_restarts=0,
            fault_hook=kill, **KW)
    assert CheckpointManager(ckpt).all_steps() == [1]
    beats = HeartbeatMonitor(num_hosts=1)
    resumed = fit(7, xs, ys, ICQConfig(**CFG), ckpt_dir=ckpt,
                  heartbeat=beats, **KW)
    _same_model(resumed, uninterrupted)
    assert len(beats._latency[0]) == 2            # epochs 2 and 3 ran
    # the reference's rule: a run never saves the step it resumes at
    assert CheckpointManager(ckpt).all_steps() == [1, 3]


def test_fit_restarts_in_process_equals_uninterrupted(guyon, uninterrupted,
                                                      tmp_path):
    """A fault raised once at epoch 2 inside one ``fit(ckpt_dir=)``
    restores the epoch-1 checkpoint and replays: the model equals the
    uninterrupted fit's bit for bit."""
    xs, ys = guyon
    crashed = []

    def once(epoch):
        if epoch == 2 and not crashed:
            crashed.append(epoch)
            raise RuntimeError("node loss")
    model = fit(7, xs, ys, ICQConfig(**CFG), ckpt_dir=str(tmp_path / "c"),
                fault_hook=once, **KW)
    assert crashed == [2]
    _same_model(model, uninterrupted)
