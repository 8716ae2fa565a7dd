"""The port's checkpoint store and the Trainer's checkpoint/restart.

The store's crash windows and corruption cases are
``tests/test_checkpoint_recovery.py``'s, against
``repro_torch.checkpoint.store``: each test builds the partial disk state
a crash leaves and asserts that recovery (run by every open) repairs it;
a corrupt group raises ``CheckpointError`` naming it, and recovery walks
back to the newest valid step.  Beyond them: round trips of bf16 (stored
as its 16-bit pattern), f32 and int64 leaves; the async saver's host copy
taken before ``save`` returns (the port updates its state in place); flat
``ctl`` / ``meta`` groups read by the other package's ``restore_group``;
and a DMM-driven 2-layer ``Trainer`` resumed from its checkpoint against
the JAX ``Trainer`` resumed from its own (equal cutoffs and clock, losses
within 1e-5), and against its own uninterrupted run (bit for bit).
"""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import store as jstore
from repro.cluster.simulator import ClusterSim as JClusterSim
from repro.configs.base import get_config as jget
from repro.core import controller as jctl
from repro.core.runtime_model.api import RuntimeModel as JRM
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.launch.train import Trainer as JTrainer
from repro.launch.train import jit_train_step
from repro.models import model as JM
from repro_torch import optim as toptim
from repro_torch import tree, weights
from repro_torch.checkpoint import store
from repro_torch.checkpoint.store import CheckpointError
from repro_torch.cluster.simulator import ClusterSim
from repro_torch.configs.base import get_config as tget
from repro_torch.core import controller as tctl
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as TT
from repro_torch.models import model as TM

torch.set_num_threads(2)


def _state(v: float):
    return {"state": {"w": torch.full((3, 2), v, dtype=torch.float64),
                      "b": torch.arange(4.0, dtype=torch.float64) * v},
            "meta": {"step": 0, "clock": 0.0}}


def _save(d, step, v, keep=10):
    st = _state(v)
    st["meta"]["step"] = step
    return store.save(str(d), step, st, keep=keep)


def _restored_value(d, step=None):
    out = store.restore(str(d), _state(0.0), step=step)
    return float(out["state"]["w"][0, 0])


def _park_as(d, step, name):
    """Move the published step dir aside under ``name`` (tmp/stale)."""
    # reprolint: disable=nonatomic-checkpoint-write -- this helper STAGES the crash windows the store must recover from
    os.rename(os.path.join(d, f"step_{step:010d}"), os.path.join(d, name))


# ---------------------------------------------------------------------------
# Crash windows, one partial disk state per test.
# ---------------------------------------------------------------------------


def test_crash_between_renames_promotes_complete_tmp(tmp_path):
    d = str(tmp_path)
    _save(d, 5, v=1.0)
    _park_as(d, 5, "stale.5")           # the old copy, parked
    scratch = tmp_path / "scratch"
    _save(scratch, 5, v=2.0)            # the new copy, fully written...
    # reprolint: disable=nonatomic-checkpoint-write -- simulates a crash mid-publish (tmp dir present, rename never ran)
    os.rename(os.path.join(scratch, f"step_{5:010d}"),
              os.path.join(d, "tmp.5"))  # ...but never published
    assert store.latest_step(d) == 5     # recovery ran on open
    assert _restored_value(d) == 2.0     # the tmp content won
    assert not os.path.exists(os.path.join(d, "tmp.5"))
    assert not os.path.exists(os.path.join(d, "stale.5"))


def test_crash_mid_write_restores_stale(tmp_path):
    d = str(tmp_path)
    _save(d, 5, v=1.0)
    _park_as(d, 5, "stale.5")
    os.makedirs(os.path.join(d, "tmp.5"))
    # reprolint: disable=nonatomic-checkpoint-write -- simulates a crash mid-WRITE: a half-baked tmp dir the store must discard
    np.savez(os.path.join(d, "tmp.5", "state.npz"), w=np.zeros(2))
    assert store.latest_step(d) == 5
    assert _restored_value(d) == 1.0     # the old checkpoint survived
    assert not os.path.exists(os.path.join(d, "tmp.5"))


def test_crash_before_stale_cleanup_drops_debris(tmp_path):
    d = str(tmp_path)
    _save(d, 5, v=1.0)
    _park_as(d, 5, "stale.5")
    scratch = tmp_path / "scratch"
    _save(scratch, 5, v=2.0)
    # reprolint: disable=nonatomic-checkpoint-write -- simulates a crash AFTER publish (stale dir left behind)
    os.rename(os.path.join(scratch, f"step_{5:010d}"),
              os.path.join(d, f"step_{5:010d}"))  # publish completed
    assert store.latest_step(d) == 5
    assert _restored_value(d) == 2.0
    assert not os.path.exists(os.path.join(d, "stale.5"))


def test_incomplete_fresh_tmp_is_debris(tmp_path):
    d = str(tmp_path)
    _save(d, 5, v=1.0)
    os.makedirs(os.path.join(d, "tmp.6"))
    # reprolint: disable=nonatomic-checkpoint-write -- simulates an orphaned tmp dir from a NEWER crashed step
    np.savez(os.path.join(d, "tmp.6", "state.npz"), w=np.zeros(2))
    assert store.latest_step(d) == 5
    assert not os.path.exists(os.path.join(d, "tmp.6"))


def test_resave_after_crash_window_does_not_lose_the_step(tmp_path):
    d = str(tmp_path)
    _save(d, 5, v=1.0)
    _park_as(d, 5, "stale.5")
    scratch = tmp_path / "scratch"
    _save(scratch, 5, v=2.0)
    # reprolint: disable=nonatomic-checkpoint-write -- simulates the crash window a later re-save must win over
    os.rename(os.path.join(scratch, f"step_{5:010d}"),
              os.path.join(d, "tmp.5"))
    _save(d, 5, v=3.0)                  # re-save of the crashed step
    assert _restored_value(d) == 3.0
    assert store.list_steps(d) == [5]


def test_keep_n_retention(tmp_path):
    for step in (1, 2, 3, 4):
        _save(tmp_path, step, v=float(step), keep=2)
    assert store.list_steps(str(tmp_path)) == [3, 4]
    assert _restored_value(tmp_path, step=3) == 3.0


# ---------------------------------------------------------------------------
# Checksums + fallback.
# ---------------------------------------------------------------------------


def _corrupt(d, step, group="state"):
    path = os.path.join(str(d), f"step_{step:010d}", f"{group}.npz")
    # reprolint: disable=nonatomic-checkpoint-write -- deliberate bit-flip so the crc32 manifest check has something to catch
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def test_corrupt_group_raises_naming_it(tmp_path):
    _save(tmp_path, 5, v=1.0)
    _corrupt(tmp_path, 5, "state")
    with pytest.raises(CheckpointError, match="group 'state'"):
        store.restore(str(tmp_path), _state(0.0))
    with pytest.raises(CheckpointError, match="group 'state'"):
        store.verify_step(str(tmp_path), 5)
    with pytest.raises(CheckpointError, match="group 'state'"):
        store.restore_group(str(tmp_path), "state")


def test_latest_valid_step_walks_past_corruption(tmp_path):
    d = str(tmp_path)
    _save(d, 5, v=1.0)
    _save(d, 10, v=2.0)
    assert store.latest_valid_step(d) == 10
    _corrupt(d, 10)
    assert store.latest_step(d) == 10          # still the newest dir...
    assert store.latest_valid_step(d) == 5     # ...but not the anchor
    assert _restored_value(d, step=5) == 1.0


def test_missing_group_file_raises(tmp_path):
    _save(tmp_path, 5, v=1.0)
    # reprolint: disable=nonatomic-checkpoint-write -- deletes a published group file to drive the missing-file error path
    os.remove(os.path.join(str(tmp_path), f"step_{5:010d}", "state.npz"))
    with pytest.raises(CheckpointError, match="file missing"):
        store.verify_step(str(tmp_path), 5)


def test_torn_manifest_raises(tmp_path):
    _save(tmp_path, 5, v=1.0)
    man = os.path.join(str(tmp_path), f"step_{5:010d}", "manifest.json")
    # reprolint: disable=nonatomic-checkpoint-write -- writes a TORN manifest on purpose to drive the corrupt-manifest error path
    with open(man, "w") as f:
        f.write('{"step": 5, "gro')
    with pytest.raises(CheckpointError, match="manifest"):
        store.verify_step(str(tmp_path), 5)


def test_pre_checksum_manifest_still_restores(tmp_path):
    d = str(tmp_path)
    _save(d, 5, v=1.0)
    man = os.path.join(d, f"step_{5:010d}", "manifest.json")
    with open(man) as f:
        manifest = json.load(f)
    for g in manifest["groups"].values():
        g.pop("crc32")
    # reprolint: disable=nonatomic-checkpoint-write -- rewrites the manifest sans checksums to simulate a pre-crc32 checkpoint
    with open(man, "w") as f:
        json.dump(manifest, f)
    assert _restored_value(d) == 1.0
    assert store.latest_valid_step(d) == 5


# ---------------------------------------------------------------------------
# Leaves, the async saver, and the other package.
# ---------------------------------------------------------------------------


def _mixed_tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"bf16": torch.randn((5, 3), generator=g).to(torch.bfloat16),
            "f32": torch.randn(7, generator=g),
            "i64": torch.arange(6, dtype=torch.int64).reshape(2, 3) * seed,
            "layers": [{"w": torch.randn((2, 2), generator=g)},
                       {"w": torch.randn((2, 2), generator=g)}],
            "np": np.arange(3, dtype=np.int64),
            "step": 3, "clock": 1.5}


def test_leaf_round_trips(tmp_path):
    d = str(tmp_path)
    tree_in = _mixed_tree(1)
    store.save(d, 1, {"state": tree_in})
    manifest = json.loads((tmp_path / f"step_{1:010d}" /
                           "manifest.json").read_text())
    assert manifest["groups"]["state"]["dtypes"] == {"bf16": "bfloat16"}
    assert "layers/1/w" in manifest["groups"]["state"]["keys"]
    out = store.restore(d, {"state": _mixed_tree(2)})["state"]
    for key in ("bf16", "f32", "i64"):
        assert out[key].dtype == tree_in[key].dtype
        assert torch.equal(out[key], tree_in[key])
    for a, b in zip(out["layers"], tree_in["layers"]):
        assert torch.equal(a["w"], b["w"])
    np.testing.assert_array_equal(out["np"], tree_in["np"])
    assert out["step"] == 3 and isinstance(out["step"], int)
    assert out["clock"] == 1.5 and isinstance(out["clock"], float)
    flat = store.restore_group(d, "state")
    assert flat["bf16"].dtype == torch.bfloat16
    assert torch.equal(flat["bf16"], tree_in["bf16"])
    assert flat["i64"].dtype == np.int64


def test_async_save_snapshots_before_returning(tmp_path, monkeypatch):
    """save, then an in-place step, then the write: the checkpoint holds
    the state at the save.  The writer thread is held until the step is
    done, so the order is certain."""
    d = str(tmp_path)
    params = {"w": torch.ones(1000), "b": torch.zeros(10,
                                                      dtype=torch.bfloat16)}
    m = {"w": torch.zeros(1000), "b": torch.zeros(10)}
    v = {"w": torch.zeros(1000), "b": torch.zeros(10)}
    want = {k: t.clone() for k, t in params.items()}
    stepped = threading.Event()
    write = store.save

    def held_save(*args, **kw):
        assert stepped.wait(timeout=30)
        return write(*args, **kw)

    monkeypatch.setattr(store, "save", held_save)
    ckpt = store.AsyncCheckpointer(d)
    ckpt.save(1, {"state": {"params": params}})
    grads = {"w": torch.ones(1000), "b": torch.ones(10,
                                                    dtype=torch.bfloat16)}
    opt = toptim.adamw(0.1, fused=True)
    opt.update(grads, {"step": 0, "m": m, "v": v}, params)   # in place
    assert not torch.equal(params["w"], want["w"])
    stepped.set()
    ckpt.wait()
    out = store.restore(d, {"state": {"params": params}})["state"]["params"]
    for k in want:
        assert torch.equal(out[k], want[k]), k


def test_async_save_raises_the_writer_error_on_wait(tmp_path, monkeypatch):
    def failing_save(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(store, "save", failing_save)
    ckpt = store.AsyncCheckpointer(str(tmp_path))
    ckpt.save(1, {"meta": {"step": 1}})
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    ckpt.wait()                          # raised once


def _ctl_groups():
    return {"ctl": {"n": np.int64(4), "members": np.asarray([0, 2, 5, 7]),
                    "step": np.int64(12),
                    "window": np.linspace(0.5, 2.0, 12).reshape(3, 4)},
            "meta": {"step": 12, "clock": 13.25}}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_flat_groups_read_across_packages(tmp_path, writer):
    d = str(tmp_path)
    save, read = ((store.save, jstore.restore_group) if writer == "port"
                  else (jstore.save, store.restore_group))
    save(d, 12, _ctl_groups())
    for name, want in _ctl_groups().items():
        got = read(d, name, step=12)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, (name, k)
            np.testing.assert_array_equal(got[k], v)
    # and the other package's verify passes over the whole step
    (jstore if writer == "port" else store).verify_step(d, 12)


# ---------------------------------------------------------------------------
# The Trainer: restore fallback, resume against JAX, resume bit for bit.
# ---------------------------------------------------------------------------


def _cfgs(n_layers=2):
    return (dataclasses.replace(jget("qwen2-0.5b").reduced(),
                                n_layers=n_layers),
            dataclasses.replace(tget("qwen2-0.5b").reduced(),
                                n_layers=n_layers))


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _port_init(tc, opt):
    def init():
        params = TM.init_model(tc, torch.Generator().manual_seed(0),
                               device="cpu")
        return {"params": params, "opt": opt.init(params)}
    return init


def test_trainer_falls_back_to_previous_step_on_corruption(tmp_path):
    _, tc = _cfgs()
    opt = toptim.adamw(1e-3, fused=True)
    step_fn = TT.make_train_step(tc, opt)
    d = str(tmp_path / "ckpt")

    def make():
        return TT.Trainer(step_fn=step_fn,
                          data=SyntheticTokens(tc.vocab_size, 8, 16, seed=0),
                          controller=tctl.ElfvingController(4), n_workers=4,
                          ckpt_dir=d, ckpt_every=4, keep=5
                          ).restore_or_init(_port_init(tc, opt))

    tr = make()
    tr.run(8)                            # checkpoints at steps 4 and 8
    assert store.list_steps(d) == [4, 8]
    _corrupt(d, 8, "state")
    tr2 = make()
    assert tr2.step == 4 and tr2.sim_clock > 0.0
    assert tr2.state["opt"]["step"] == 4
    grp = store.restore_group(d, "ctl", step=4)
    assert int(grp["step"]) == 4 and "window" not in grp
    _corrupt(d, 4, "meta")
    tr3 = make()
    assert tr3.step == 0 and tr3.state["opt"]["step"] == 0   # cold, alive


@pytest.fixture(scope="module")
def fitted8():
    trace = JClusterSim(n_workers=8, n_nodes=2, seed=0).run(60)
    rm = JRM(n_workers=8, lag=20).init(0)
    rm.fit(trace, steps=20, batch=8, seed=0)
    port = weights.runtime_model_from_jax(_np_tree(rm.params), rm.norm_scale,
                                          lag=rm.lag, device="cpu")
    return rm, port, trace


def test_resumed_dmm_trainer_matches_the_resumed_jax_trainer(tmp_path,
                                                             fitted8):
    """Both packages run 3 steps checkpointing at step 3, then a fresh
    Trainer (a fresh controller, the timer from its seed) resumes from
    each package's own checkpoint for 3 steps: the same step, clock and
    cutoffs, the controller's step and window restored, losses within
    1e-5."""
    rm, trm, trace = fitted8
    jc, tc = _cfgs()
    jopt, topt = joptim.adamw(3e-3), toptim.adamw(3e-3, fused=True)
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    jinit = {"params": params, "opt": jopt.init(params)}
    jstep = jit_train_step(jc, jopt, mask_agg="psum")
    tstep = TT.make_train_step(tc, topt, mask_agg="psum")
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")

    def jtrainer():
        ctl = jctl.CutoffController(rm, k_samples=48)
        ctl.seed_window(trace)
        return JTrainer(cfg=jc, step_fn=jstep,
                        data=JTokens(jc.vocab_size, 16, 8, seed=0),
                        controller=ctl,
                        timer=JClusterSim(n_workers=8, n_nodes=2, seed=7),
                        n_workers=8, mask_agg="psum", ckpt_dir=jd,
                        ckpt_every=3).restore_or_init(
            lambda: jax.tree.map(jnp.copy, jinit))

    def ttrainer():
        ctl = tctl.CutoffController(trm, k_samples=48)
        ctl.seed_window(trace)
        return TT.Trainer(step_fn=tstep,
                          data=SyntheticTokens(tc.vocab_size, 16, 8, seed=0),
                          controller=ctl,
                          timer=ClusterSim(n_workers=8, n_nodes=2, seed=7),
                          n_workers=8, mask_agg="psum", ckpt_dir=td,
                          ckpt_every=3).restore_or_init(
            lambda: weights.state_from_jax(tc, _np_tree(jinit),
                                           device="cpu"))

    jtrainer().run(3)
    ttrainer().run(3)
    jt, tt = jtrainer(), ttrainer()
    assert tt.step == jt.step == 3 and tt.sim_clock == jt.sim_clock
    assert tt.controller._step == jt.controller._step == 3
    np.testing.assert_allclose(tt.controller.window_array(),
                               jt.controller.window_array(), rtol=2e-3,
                               atol=2e-3)
    jh, th = jt.run(3), tt.run(3)
    assert [(h["step"], h["c"], h["clock"]) for h in th] \
        == [(h["step"], h["c"], h["clock"]) for h in jh]
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=1e-5)


def test_resumed_stale_reuse_trainer_equals_the_uninterrupted_run(
        tmp_path, fitted8):
    """StaleReuseController(CutoffController, 0.5), psum: a Trainer
    restored from the step-2 checkpoint (the timer advanced to the same
    step) takes steps 3-4 exactly as the uninterrupted run does: the same
    cutoffs, params, m and v bit for bit.  The controller's step comes
    back through the wrapper and the stale buffer through its group."""
    _, trm, trace = fitted8
    _, tc = _cfgs()
    opt = toptim.adamw(3e-3, fused=True)
    step_fn = TT.make_train_step(tc, opt, mask_agg="psum", stale_reuse=True)
    d = str(tmp_path / "ckpt")

    def make(timer_steps, ckpt_every):
        ctl = tctl.StaleReuseController(
            tctl.CutoffController(trm, k_samples=48), decay=0.5)
        ctl.seed_window(trace)
        timer = ClusterSim(n_workers=8, n_nodes=2, seed=7)
        for _ in range(timer_steps):
            timer.step()
        return TT.Trainer(step_fn=step_fn,
                          data=SyntheticTokens(tc.vocab_size, 16, 8, seed=0),
                          controller=ctl, timer=timer, n_workers=8,
                          mask_agg="psum", ckpt_dir=d,
                          ckpt_every=ckpt_every).restore_or_init(
            _port_init(tc, opt))

    full = make(0, 2)
    hist = full.run(2)
    assert store.groups(d, 2) == ["ctl", "meta", "stale", "state"]
    full.ckpt_dir = None
    hist = full.run(2)
    resumed = make(2, 2)
    assert resumed.step == 2 and resumed.controller._step == 2
    # step 2 dropped workers: the restored buffer carries weight
    assert float(resumed._stale[1]) == 8 - hist[1]["c"] > 0
    rhist = resumed.run(2)
    assert [(h["c"], h["clock"]) for h in rhist] \
        == [(h["c"], h["clock"]) for h in hist[2:]]
    assert min(h["c"] for h in hist) < 8
    for key in ("params", "m", "v"):
        a = full.state[key] if key == "params" else full.state["opt"][key]
        b = (resumed.state[key] if key == "params"
             else resumed.state["opt"][key])
        assert all(torch.equal(x, y) for x, y in
                   zip(tree.leaves(a), tree.leaves(b))), key
