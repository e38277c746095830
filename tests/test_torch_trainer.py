"""The port's fault-tolerant trainer and checkpoints
(``repro_torch.train.trainer``, ``repro_torch.checkpoint``): twins of
``tests/test_trainer_ft.py``, of the six crash tests of
``tests/test_checkpoint.py`` (over numpy and over torch leaves, the latter
restored in place) and of ``test_substrate.py``'s checkpoint round trip;
commits crossing between the packages both ways; the train launcher and
the example twin run on the CPU.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.checkpoint.manager import _flatten as ref_flatten
from repro.configs import get_config as ref_config
from repro.launch.train import batch_iter as ref_batch_iter
from repro.models import init_params as ref_init
from repro.train.steps import train_state_init as ref_train_state_init
from repro.train.steps import make_train_step as ref_make_train_step
from repro_torch import interop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch.train import batch_iter
from repro_torch.optim import adamw as TA
from repro_torch.train.steps import loss_and_grads
from repro_torch.train.trainer import StragglerMonitor, Trainer, TrainerConfig, init_state

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is small ops; with torch's default thread
    pool beside the other test workers' busy cores it spends its time in
    thread hand-offs, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_weights(arch, seed):
    """The reference's initialisation of the reduced ``arch`` (f32)."""
    rc = ref_config(arch, reduced=True)
    return jax.jit(lambda k: ref_init(k, rc)[0])(jax.random.PRNGKey(seed))


# ---------------------------------------------------------------------------
# the trainer (twins of tests/test_trainer_ft.py)
# ---------------------------------------------------------------------------

def test_failure_restart_and_progress(tmp_path):
    """From the reference's own seed-0 weights, so the losses are its
    test's (the port's steps equal the reference's; on these random tokens
    a 14-step curve is mostly batch noise, and the reference's test sees it
    fall from its initialisation)."""
    cfg = get_config("yi-6b", reduced=True)
    tcfg = TrainerConfig(total_steps=14, checkpoint_every=4, checkpoint_dir=str(tmp_path),
                         async_checkpoint=True)
    start = interop.train_state_from_jax(cfg, jax.tree.map(
        np.asarray, ref_train_state_init(ref_weights("yi-6b", 0))), "cpu")

    class Fault:
        fired = False

        def __call__(self, step):
            if step == 9 and not self.fired:
                self.fired = True
                raise RuntimeError("injected")

    t = Trainer(cfg, tcfg, batch_iter(cfg, 2, 128, dedup=False), fault_hook=Fault(),
                device="cpu", state=start)
    res = t.run()
    assert res["final_step"] == 14
    assert res["restarts"] == 1
    ev = [m for m in res["log"] if m.get("event") == "restart"][0]
    assert ev["restored_step"] == 8
    assert ev["manifest_restore_s"] < 0.1      # instant restore
    losses = [m["loss"] for m in res["log"] if "loss" in m]
    assert losses[-1] < losses[0]

    # resume across process restarts
    t2 = Trainer(cfg, tcfg, batch_iter(cfg, 2, 128, dedup=False), device="cpu")
    assert t2.resume_if_possible() == 14


def test_straggler_monitor():
    m = StragglerMonitor(window=20, sigma=3.0)
    for i in range(15):
        m.record(i, 0.10 + 0.001 * (i % 3))
    assert m.record(15, 0.5) is True
    assert not m.record(16, 0.101)
    assert len(m.flagged) == 1


def test_non_finite_loss_restores_in_place(tmp_path):
    """A NaN in the masters makes the next loss non-finite: the trainer
    restores the last commit into the same tensors and continues; past
    ``max_restarts`` the error is raised."""
    cfg = dataclasses.replace(get_config("yi-6b", reduced=True), dtype="float32")
    tcfg = TrainerConfig(total_steps=6, checkpoint_every=2, checkpoint_dir=str(tmp_path),
                         async_checkpoint=False)
    poison = {"at": {3}}

    def fault(step):
        if step in poison["at"]:
            poison["at"].discard(step)
            t.state.params["norm_f"]["scale"][0] = float("nan")

    t = Trainer(cfg, tcfg, batch_iter(cfg, 2, 64, dedup=False), fault_hook=fault, seed=3,
                device="cpu")
    scale = t.state.params["norm_f"]["scale"]
    res = t.run()
    ev = [m for m in res["log"] if m.get("event") == "restart"]
    assert len(ev) == 1 and ev[0]["restored_step"] == 2 and "non-finite" in ev[0]["error"]
    assert t.state.params["norm_f"]["scale"] is scale and torch.isfinite(scale).all()
    assert res["final_step"] == 6

    poison["at"] = set(range(6, 20))
    t.tcfg.total_steps, t.tcfg.max_restarts = 20, 2
    with pytest.raises(FloatingPointError):
        t.run()


def test_trainer_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = get_config("yi-6b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainerConfig(checkpoint_dir=str(tmp_path)), iter(()))


# ---------------------------------------------------------------------------
# the commit protocol (twins of tests/test_checkpoint.py, over numpy leaves
# and over torch leaves restored in place)
# ---------------------------------------------------------------------------

class Boom(RuntimeError):
    pass


LEAVES = ["numpy", "torch"]


def _tree(step, kind):
    tree = {"w": np.full((4, 4), step, np.float32),
            "opt": {"m": np.full(3, step * 10, np.float32)}}
    if kind == "torch":
        tree = {"w": torch.from_numpy(tree["w"]), "opt": {"m": torch.from_numpy(tree["opt"]["m"])}}
    return tree


def _restore_step(mgr, kind):
    manifest, lazy, _ = mgr.restore_manifest()
    assert manifest is not None
    template = _tree(0, kind)
    tree = mgr.restore_tree(template, lazy)
    if kind == "torch":
        assert tree is template          # loaded in place
        tree = {"w": tree["w"].numpy(), "opt": {"m": tree["opt"]["m"].numpy()}}
    return manifest["step"], tree


@pytest.mark.parametrize("kind", LEAVES)
def test_commit_then_restore_roundtrip(tmp_path, kind):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1, kind))
    mgr.save(2, _tree(2, kind))
    step, tree = _restore_step(mgr, kind)
    assert step == 2 and (tree["w"] == 2).all() and (tree["opt"]["m"] == 20).all()


@pytest.mark.parametrize("kind", LEAVES)
def test_crash_between_data_write_and_commit_rename(tmp_path, monkeypatch, kind):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1, kind))

    real_rename = Path.rename

    def exploding_rename(self, target):
        if ".stage_" in self.name or ".stage_" in str(self):
            raise Boom("crash before commit rename")
        return real_rename(self, target)

    monkeypatch.setattr(Path, "rename", exploding_rename)
    with pytest.raises(Boom):
        mgr.save(2, _tree(2, kind))
    monkeypatch.undo()

    step, tree = _restore_step(mgr, kind)
    assert step == 1 and (tree["w"] == 1).all()
    mgr2 = CheckpointManager(str(tmp_path), keep=3)
    mgr2.save(2, _tree(2, kind))
    step, tree = _restore_step(mgr2, kind)
    assert step == 2 and (tree["w"] == 2).all()


@pytest.mark.parametrize("kind", LEAVES)
def test_crash_between_rename_and_latest_repoint(tmp_path, monkeypatch, kind):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1, kind))

    def exploding_replace(src, dst):
        raise Boom("crash before LATEST repoint")

    monkeypatch.setattr(os, "replace", exploding_replace)
    with pytest.raises(Boom):
        mgr.save(2, _tree(2, kind))
    monkeypatch.undo()

    assert (tmp_path / "LATEST").read_text().strip().endswith("0000000001")
    step, _ = _restore_step(mgr, kind)
    assert step == 1
    (tmp_path / "LATEST").unlink()
    step, tree = _restore_step(mgr, kind)
    assert step == 2 and (tree["w"] == 2).all()


@pytest.mark.parametrize("kind", LEAVES)
def test_resave_same_step_never_loses_only_copy(tmp_path, monkeypatch, kind):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, _tree(5, kind))

    real_rename = Path.rename

    def exploding_rename(self, target):
        if ".stage_" in str(self):
            raise Boom("crash mid re-save")
        return real_rename(self, target)

    monkeypatch.setattr(Path, "rename", exploding_rename)
    with pytest.raises(Boom):
        mgr.save(5, _tree(0, kind))
    monkeypatch.undo()

    mgr2 = CheckpointManager(str(tmp_path), keep=3)
    step, tree = _restore_step(mgr2, kind)
    assert step == 5
    assert (tree["w"] == 5).all()      # the original commit survived


@pytest.mark.parametrize("kind", LEAVES)
def test_torn_manifest_ignored_by_fallback(tmp_path, kind):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1, kind))
    fake = tmp_path / "step_0000000009"
    fake.mkdir()
    (fake / "manifest.json").write_text('{"step": 9, "clean":')   # torn
    (tmp_path / "LATEST").unlink()
    step, _ = _restore_step(mgr, kind)
    assert step == 1


@pytest.mark.parametrize("kind", LEAVES)
def test_dirty_restart_bumps_version(tmp_path, kind):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree(3, kind), clean=True, version=7)
    mgr.mark_dirty(3)
    manifest, _, seconds = mgr.restore_manifest()
    assert manifest["version"] == 8 and not manifest["clean"]
    assert seconds < 1.0


def test_checkpoint_atomic_commit_and_instant_restore(tmp_path):
    """Twin of ``test_substrate.test_checkpoint_atomic_commit_and_instant_restore``,
    with torch leaves (a restore refuses a leaf of another shape)."""
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(10_000, dtype=torch.float32), "b": {"c": torch.ones((64, 64))}}
    cm.save(10, tree, clean=False, version=1)
    cm.save(20, tree, clean=True, version=1)
    assert cm.latest_step() == 20
    manifest, lazy, secs = cm.restore_manifest()
    assert secs < 0.1                      # instant: manifest only
    assert manifest["version"] == 1        # clean -> no bump
    target = {"a": torch.zeros(10_000), "b": {"c": torch.zeros((64, 64))}}
    restored = cm.restore_tree(target, lazy)
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(10_000))
    assert cm.last_restore["bytes"] == 10_000 * 4 + 64 * 64 * 4
    with pytest.raises(ValueError, match="b/c"):
        cm.restore_tree({"a": torch.zeros(10_000), "b": {"c": torch.zeros((64, 63))}}, lazy)
    cm.mark_dirty(20)
    m2, _, _ = cm.restore_manifest()
    assert m2["version"] == 2
    cm.save(30, tree)
    cm.save(40, tree)
    steps = sorted(d.name for d in tmp_path.iterdir() if d.name.startswith("step"))
    assert len(steps) == 2
    assert [s["step"] for s in cm.saves] == [10, 20, 30, 40]
    assert all(s["bytes"] == cm.last_restore["bytes"] and s["write_s"] >= 0 for s in cm.saves)


# ---------------------------------------------------------------------------
# commits across the packages
# ---------------------------------------------------------------------------

def _f32(arch):
    rc = dataclasses.replace(ref_config(arch, reduced=True), dtype="float32")
    return rc, dataclasses.replace(get_config(arch, reduced=True), dtype="float32")


def test_port_resumes_a_reference_commit(tmp_path):
    """The reference's train step runs 5 steps (its trainer's loop: a step,
    then the reference's manager commits at step 2); the port's trainer
    resumes from that commit (its data skipped to the same batch) and its
    losses at steps 2-4 are the reference's continuation within 1e-4."""
    rc, pc = _f32("yi-6b")
    state = ref_train_state_init(TA.map_tree(lambda t: jnp.asarray(t.numpy()),
                                             init_state(pc, 0, "cpu").params))
    step_fn = jax.jit(ref_make_train_step(rc))
    ref_dir = tmp_path / "ref"
    mgr = RefCheckpointManager(str(ref_dir))
    want = []
    for step, batch in zip(range(5), ref_batch_iter(rc, 2, 64, dedup=False)):
        state, metrics = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append(float(metrics["loss"]))
        if step + 1 == 2:
            mgr.save(2, state, clean=False, version=1)
    it = batch_iter(pc, 2, 64, dedup=False)
    next(it), next(it)
    t = Trainer(pc, TrainerConfig(total_steps=5, checkpoint_every=100,
                                  checkpoint_dir=str(ref_dir)), it, device="cpu")
    assert t.resume_if_possible() == 2
    assert int(t.state.step) == 2 and int(t.state.opt.count) == 2 and t.version == 2
    log = t.run()["log"]
    assert [m["step"] for m in log] == [2, 3, 4]
    np.testing.assert_allclose([m["loss"] for m in log], want[2:], rtol=1e-4, atol=1e-4)


def test_reference_restores_a_port_commit(tmp_path):
    """The port's trainer commits (two steps of the reduced mixtral, f32);
    the reference's manager restores it into the reference's own
    ``TrainState`` — the same keys, shapes and dtypes — with the port's
    values."""
    _, pc = _f32("mixtral-8x7b")
    t = Trainer(pc, TrainerConfig(total_steps=2, checkpoint_every=100,
                                  checkpoint_dir=str(tmp_path)),
                batch_iter(pc, 2, 64, dedup=False), device="cpu")
    t.run()
    port = interop.train_state_to_numpy(t.state)
    template = ref_train_state_init(TA.map_tree(lambda t: np.zeros(t.shape, np.float32),
                                                t.state.params))
    mgr = RefCheckpointManager(str(tmp_path))
    manifest, lazy, _ = mgr.restore_manifest()
    assert manifest["step"] == 2 and manifest["clean"]
    restored, _ = ref_flatten(mgr.restore_tree(template, lazy))
    want, _ = ref_flatten(template)
    assert list(restored) == list(want) == list(port)
    for k, v in restored.items():
        v = np.asarray(v)
        assert v.shape == np.shape(want[k]) and v.dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(v, port[k]), k
    assert mgr.latest_step() == 2


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------

def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_train_launcher_with_dedup_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --dedup`` exits 0
    after its commits, and the loss falls: on the run's first batch the
    committed weights score below the seed-0 initialisation (on these
    random tokens step-to-step losses are batch noise at this length)."""
    import json
    out = _run(["-m", "repro_torch.launch.train", "--device", "cpu", "--dedup", "--steps", "8",
                "--batch", "2", "--seq", "64", "--ckpt-every", "4",
                "--ckpt-dir", str(tmp_path / "ckpt")], tmp_path)
    assert "[train] yi-6b done: steps=8" in out and "restarts=0" in out, out
    last = json.loads(out.strip().splitlines()[-1])
    assert np.isfinite([last["first_loss"], last["last_loss"]]).all()
    cfg = get_config("yi-6b", reduced=True)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    manifest, lazy, _ = mgr.restore_manifest()
    assert manifest["step"] == 8 and manifest["clean"]
    final = interop.train_state_from_jax(cfg, {k: v.get() for k, v in lazy.items()}, "cpu")
    first = {k: torch.as_tensor(v) for k, v in
             next(batch_iter(cfg, 2, 64, dedup=True, device="cpu")).items()}
    before = float(loss_and_grads(cfg, init_state(cfg, 0, "cpu").params, first)[0])
    after = float(loss_and_grads(cfg, final.params, first)[0])
    np.testing.assert_allclose(before, last["first_loss"], rtol=1e-6)
    assert after < before


def test_example_twin_runs_on_cpu(tmp_path):
    out = _run([str(ROOT / "examples" / "train_lm_torch.py"), "--device", "cpu", "--steps", "3",
                "--d-model", "64", "--layers", "2", "--seq", "64", "--batch", "2",
                "--ckpt", str(tmp_path / "ckpt")], tmp_path)
    assert "steps=3 loss" in out, out
