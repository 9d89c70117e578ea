"""Parity of the port's checkpoints, fault tolerance and gradient
compression (``repro_torch.distributed``) with the reference package, on
the CPU.

Checkpoints: the reference's five cases on the port; a tree saved by the
port is the reference's directory byte for byte (manifest and ``.npy``
files, float32, int32 and bfloat16 leaves); a checkpoint either package
saves restores in the other with equal leaves (the reference cannot
restore bfloat16 leaves, its own included: ROADMAP C13). Fault tolerance:
the reference's crash-and-resume case, bit for bit, and its watchdog case.
Compression: ``int8_compress`` / ``int8_decompress`` and the error-feedback
residual equal to the reference's element for element (both divide in
IEEE float32 and round half to even); the mesh reductions raise, naming
their ROADMAP item.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed import checkpoint as jax_ckpt  # noqa: E402
from repro.distributed import compression as jax_comp  # noqa: E402
from repro.optim import AdamWState as JaxAdamWState  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    SimulatedFailure, StragglerWatchdog, TrainingSupervisor)
from repro_torch.optim import AdamWState  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


# ---------------------------------------------------------------------------
# checkpoint: the reference's cases
# ---------------------------------------------------------------------------
def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


def _equal_trees(x, y):
    from repro_torch.pytree import flatten_with_path

    fx, fy = flatten_with_path(x), flatten_with_path(y)
    assert [p for p, _ in fx] == [p for p, _ in fy]
    for (_, a), (_, b) in zip(fx, fy):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    t = _tree()
    cm.save(10, t)
    _equal_trees(cm.restore_into(10, t), t)


def test_checkpoint_async_and_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree())
    cm.wait()
    assert cm.all_steps() == [3, 4]


def test_checkpoint_skips_corrupt(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(1, _tree())
    cm.save(2, _tree())
    d = os.path.join(str(tmp_path), "step_00000002")
    victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, victim), "wb") as f:
        f.write(b"garbage")
    r = cm.restore_latest()
    assert r is not None and r["step"] == 1


def test_checkpoint_restore_latest_empty(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    assert cm.restore_latest() is None


def test_checkpoint_atomicity_tmp_never_visible(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(5, _tree())
    assert not any(n.startswith(".tmp") for n in os.listdir(str(tmp_path)))


def test_checkpoint_async_save_error_surfaces_on_wait(tmp_path,
                                                     monkeypatch):
    """An error of the background serialization is raised by the next
    ``wait`` (or ``save``), once; the failed step leaves no directory."""
    from repro_torch.distributed import checkpoint as ckpt_mod

    def disk_full(path, data, dtype):
        raise OSError("disk full")

    cm = CheckpointManager(str(tmp_path), async_save=True)
    cm.save(1, _tree())
    cm.wait()
    monkeypatch.setattr(ckpt_mod, "_save_npy", disk_full)
    cm.save(2, _tree())
    with pytest.raises(OSError, match="disk full"):
        cm.wait()
    cm.wait()                                  # raised once
    assert cm.all_steps() == [1]


# ---------------------------------------------------------------------------
# checkpoint: the interchange with the reference
# ---------------------------------------------------------------------------
def _state_pair():
    """A training state in both packages: float32 params, an int32 step,
    bfloat16 and float32 moments, under ``{"state": (params, AdamWState)}``
    as the supervisor saves it."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    m = rng.normal(size=(3, 4)).astype(np.float32)
    port = {"state": ({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                      AdamWState(step=torch.tensor(7, dtype=torch.int32),
                                 m={"w": torch.from_numpy(m).bfloat16(),
                                    "b": torch.zeros(4)},
                                 v={"w": torch.ones(3, 4).bfloat16(),
                                    "b": torch.ones(4)}))}
    ref = {"state": ({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     JaxAdamWState(step=jnp.asarray(7, jnp.int32),
                                   m={"w": jnp.asarray(m, jnp.bfloat16),
                                      "b": jnp.zeros(4)},
                                   v={"w": jnp.ones((3, 4), jnp.bfloat16),
                                      "b": jnp.ones(4)}))}
    return port, ref


def _dir_bytes(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_checkpoint_files_are_the_reference_files_bytewise(tmp_path):
    port, ref = _state_pair()
    CheckpointManager(str(tmp_path / "p"), async_save=False).save(3, port)
    jax_ckpt.CheckpointManager(str(tmp_path / "r"), async_save=False).save(
        3, ref)
    got = _dir_bytes(tmp_path / "p" / "step_00000003")
    want = _dir_bytes(tmp_path / "r" / "step_00000003")
    assert "state__1__m__w__shard0.npy" in got
    assert got == want


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    port, ref = _state_pair()
    jax_ckpt.CheckpointManager(str(tmp_path), async_save=False).save(4, ref)
    cm = CheckpointManager(str(tmp_path))
    assert cm._valid(4)
    like = {"state": ({"w": torch.zeros(3, 4), "b": torch.zeros(4)},
                      AdamWState(step=torch.tensor(0, dtype=torch.int32),
                                 m={"w": torch.zeros(3, 4).bfloat16(),
                                    "b": torch.ones(4)},
                                 v={"w": torch.zeros(3, 4).bfloat16(),
                                    "b": torch.zeros(4)}))}
    _equal_trees(cm.restore_into(4, like), port)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """Every float32 and int32 leaf the port writes restores in the
    reference, equal; a bfloat16 leaf does not restore there, as the
    reference's own do not (C13)."""
    port, ref = _state_pair()
    CheckpointManager(str(tmp_path / "f32"), async_save=False).save(
        5, {"state": (port["state"][0], port["state"][1].step)})
    cm = jax_ckpt.CheckpointManager(str(tmp_path / "f32"))
    got = cm.restore_into(5, {"state": (ref["state"][0],
                                        ref["state"][1].step)})
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(
            {"state": (ref["state"][0], ref["state"][1].step)})):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    CheckpointManager(str(tmp_path / "bf16"), async_save=False).save(5, port)
    jax_ckpt.CheckpointManager(str(tmp_path / "bf16r"),
                               async_save=False).save(5, ref)
    for d in ("bf16", "bf16r"):
        with pytest.raises(ValueError, match="cast"):
            jax_ckpt.CheckpointManager(str(tmp_path / d)).restore(5)


# ---------------------------------------------------------------------------
# fault tolerance: the reference's cases
# ---------------------------------------------------------------------------
def _quadratic_problem():
    """Minimize ||w - target||^2 with per-step deterministic batches."""
    target = torch.arange(8.0)

    def step(w, n_done, batch):
        g = 2 * (w - target) + 0.01 * batch
        w = w - 0.05 * g
        return w, n_done + 1, {"loss": torch.sum((w - target) ** 2)}

    def batch_fn(s):
        return torch.from_numpy(
            np.random.default_rng(s).normal(size=8).astype(np.float32))

    return step, (torch.zeros(8), torch.tensor(0)), batch_fn


def test_supervisor_crash_resume_bitwise(tmp_path):
    step, init, batch_fn = _quadratic_problem()
    sup_ref = TrainingSupervisor(step, init, batch_fn)
    ref = sup_ref.run(60)
    assert ref["final_step"] == 60 and ref["metrics"][-1]["step"] == 60
    ckdir = str(tmp_path / "ck")
    sup1 = TrainingSupervisor(step, init, batch_fn, checkpoint_dir=ckdir,
                              save_every=20)
    with pytest.raises(SimulatedFailure):
        sup1.run(60, fail_at_step=45)
    sup1.ckpt.wait()
    sup2 = TrainingSupervisor(step, init, batch_fn, checkpoint_dir=ckdir,
                              save_every=20)
    assert sup2.start_step == 40
    sup2.run(60)
    assert torch.equal(sup2.state[0], sup_ref.state[0])
    assert int(sup2.state[1]) == 60


def test_straggler_watchdog():
    wd = StragglerWatchdog(threshold=3.0, warmup=5)
    for s in range(20):
        wd.observe(s, 0.01)
    assert wd.observe(20, 0.2)  # 20x slower -> flagged
    assert len(wd.report.slow_steps) == 1
    assert wd.report.ewma_s < 0.02


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 40.0)])
def test_int8_compress_matches_reference(seed, scale):
    g = (np.random.default_rng(seed).normal(size=(257,)) * scale
         ).astype(np.float32)
    c = comp.int8_compress(torch.from_numpy(g))
    jc = jax_comp.int8_compress(jnp.asarray(g))
    assert c.q.dtype == torch.int8
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(jc.q))
    assert float(c.scale) == float(jc.scale)
    np.testing.assert_array_equal(comp.int8_decompress(c).numpy(),
                                  np.asarray(jax_comp.int8_decompress(jc)))
    back = comp.int8_decompress(c)
    assert float((back - torch.from_numpy(g)).abs().max()) \
        <= float(c.scale) * 0.51


def test_error_feedback_residual_matches_reference():
    """The EF loop of the reference's test, in both packages: the residual
    equal at every step, and bounded."""
    rng = np.random.default_rng(1)
    state = comp.ef_init({"g": torch.zeros(128)})
    jstate = jax_comp.ef_init({"g": jnp.zeros(128)})
    r, jr = state.residual["g"], jstate.residual["g"]
    assert r.dtype == torch.float32
    norms = []
    for _ in range(50):
        g = rng.normal(size=128).astype(np.float32)
        corrected = torch.from_numpy(g) + r
        r = corrected - comp.int8_decompress(comp.int8_compress(corrected))
        jcorr = jnp.asarray(g) + jr
        jr = jcorr - jax_comp.int8_decompress(jax_comp.int8_compress(jcorr))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        norms.append(float(torch.linalg.vector_norm(r)))
    assert max(norms[10:]) < 1.0


@pytest.mark.parametrize("fn", ["psum_bf16", "psum_int8", "ef_compress_psum"])
def test_mesh_reductions_refuse_on_one_card(fn):
    args = ({"g": torch.zeros(4)}, "data")
    if fn == "ef_compress_psum":
        args = ({"g": torch.zeros(4)}, comp.ef_init({"g": torch.zeros(4)}),
                "data")
    with pytest.raises(NotImplementedError, match="item 10"):
        getattr(comp, fn)(*args)
