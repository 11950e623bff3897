"""The port's data pipeline, checkpoints, fault-tolerant loop and training
launcher, on the CPU.

The fault-tolerance and run-training cases are copies of
``tests/test_fault_tolerance.py``'s and ``tests/test_substrate.py``'s, with
the port's transient error (``torch.cuda.OutOfMemoryError``) in place of
``jax.errors.JaxRuntimeError``.  Checkpoints are also read across the two
packages: the on-disk format is shared.
"""
import json
import os
import signal

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.optim.adamw import adamw_init as jadamw_init

from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore_pytree, save_pytree)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.runtime.fault_tolerance import (TRANSIENT, FTConfig,
                                                 PreemptionGuard,
                                                 StragglerWatch, run_training)


# --------------------------------------------------------------------------- #
# data pipeline
# --------------------------------------------------------------------------- #
def test_pipeline_deterministic_and_sharded():
    cfg = DataConfig(vocab=1000, seq_len=64, global_batch=8, seed=7)
    pipe = TokenPipeline(cfg)
    b1, b2 = pipe.batch(3), TokenPipeline(cfg).batch(3)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["labels"], b2["labels"])
    assert not torch.equal(pipe.batch(4)["tokens"], b1["tokens"])
    other = TokenPipeline(DataConfig(vocab=1000, seq_len=64, global_batch=8,
                                     seed=8))
    assert not torch.equal(other.batch(3)["tokens"], b1["tokens"])
    # host shards tile the global batch exactly
    h0 = pipe.host_batch(3, 0, 2)
    h1 = pipe.host_batch(3, 1, 2)
    for key in ("tokens", "labels"):
        assert torch.equal(torch.cat([h0[key], h1[key]]), b1[key])
    # labels are next-token shifted
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    assert b1["tokens"].shape == (8, 64) and b1["tokens"].dtype == torch.int32
    assert 0 <= int(b1["tokens"].min()) and int(b1["tokens"].max()) < 1000


def test_pipeline_distribution():
    """The reference's distribution: Zipf ranks (token 3 about twice token
    7's count), the specials rare, and BOS resets at 1/mean_doc_len."""
    cfg = DataConfig(vocab=512, seq_len=512, global_batch=64, seed=1,
                     mean_doc_len=64)
    toks = TokenPipeline(cfg).batch(0)["tokens"].flatten()
    counts = torch.bincount(toks.long(), minlength=cfg.vocab).double()
    n = toks.numel()
    probs = 1.0 / torch.arange(1, cfg.vocab + 1, dtype=torch.float64)
    probs[:3] = probs.max() * 0.01
    probs /= probs.sum()
    # each count within 5 standard deviations of its expectation
    expect = probs * (1 - 1 / cfg.mean_doc_len)
    expect[cfg.bos] += 1 / cfg.mean_doc_len
    for tok in (cfg.bos, cfg.eos, 0, 3, 7, 300):
        e = float(expect[tok]) * n
        assert abs(float(counts[tok]) - e) < 5 * e ** 0.5 + 1, tok
    assert counts[3] > 1.6 * counts[7]          # ranks 4 and 8: 2x


# --------------------------------------------------------------------------- #
# checkpointing
# --------------------------------------------------------------------------- #
def test_checkpoint_roundtrip(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.linspace(-2, 2, 5).bfloat16()},
            "step": torch.tensor(7, dtype=torch.int32)}
    save_pytree(tree, str(tmp_path), 42)
    assert latest_step(str(tmp_path)) == 42
    like = {"w": torch.zeros(3, 4), "nested": {"b": torch.zeros(5)},
            "step": torch.tensor(0)}
    restored, step = restore_pytree(like, str(tmp_path))
    assert step == 42
    assert torch.equal(restored["w"], tree["w"])
    # the stored dtype wins over the template's
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 7
    assert list(restored) == list(like)


def test_checkpoint_optimizer_state_roundtrip(tmp_path):
    """A (params, AdamWState) state: the names are the reference's keystr
    form, leaves in JAX's flatten order."""
    params = {"layers": {"w": torch.ones(2, 3)}, "embed": torch.ones(4, 3)}
    opt = adamw_init(params)
    opt = AdamWState(step=opt.step + 5, m=opt.m, v=opt.v)
    save_pytree((params, opt), str(tmp_path), 5)
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        names = json.load(f)["names"]
    assert names == ["[0]['embed']", "[0]['layers']['w']", "[1].step",
                     "[1].m['embed']", "[1].m['layers']['w']",
                     "[1].v['embed']", "[1].v['layers']['w']"]
    (p2, o2), _ = restore_pytree((params, adamw_init(params)), str(tmp_path))
    assert isinstance(o2, AdamWState) and int(o2.step) == 5
    assert torch.equal(p2["layers"]["w"], params["layers"]["w"])


def test_checkpoint_restores_onto_a_given_device(tmp_path):
    """A template on the meta device (shapes only, no memory) restored
    onto the CPU."""
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    save_pytree(tree, str(tmp_path), 2)
    like = {k: torch.empty_like(v, device="meta") for k, v in tree.items()}
    got, _ = restore_pytree(like, str(tmp_path), device="cpu")
    assert got["w"].device.type == "cpu" and torch.equal(got["w"], tree["w"])


def test_checkpoint_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, every=10)
    tree = {"x": torch.zeros(3)}
    for s in (10, 20, 30, 40):
        assert mgr.maybe_save(tree, s)
    assert not mgr.maybe_save(tree, 41)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000030", "step_00000040"]


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    save_pytree({"x": torch.zeros(3)}, str(tmp_path), 1)
    with pytest.raises(ValueError, match="shape"):
        restore_pytree({"x": torch.zeros(4)}, str(tmp_path))


def test_checkpoint_other_tree_rejected(tmp_path):
    save_pytree({"x": torch.zeros(3)}, str(tmp_path), 1)
    with pytest.raises(ValueError, match="leaves"):
        restore_pytree({"y": torch.zeros(3)}, str(tmp_path))


def test_checkpoint_left_half_written_is_invisible(tmp_path):
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert latest_step(str(tmp_path)) is None
    save_pytree({"x": torch.ones(2)}, str(tmp_path), 9)
    assert sorted(os.listdir(tmp_path)) == ["step_00000009"]


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((6, 4)).astype(np.float32),
            "layers": {"wq": rng.standard_normal((2, 4, 4)).astype(np.float32),
                       "ln1": rng.standard_normal((2, 4)).astype(np.float32)},
            "ln_f": rng.standard_normal(4).astype(np.float32),
            "head": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16)}


def _torch_tree(tree):
    return jax.tree.map(
        lambda a: torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a), tree)


def test_reference_restores_a_port_checkpoint(tmp_path):
    """Params (a bf16 leaf among them) and an optimizer state written by
    the port, read by the reference's restore_pytree."""
    tree = _params(0)
    params = _torch_tree(tree)
    save_pytree(params, str(tmp_path / "p"), 3)
    like = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), tree)
    got, step = jckpt.restore_pytree(like, str(tmp_path / "p"))
    assert step == 3
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(a), b)
    f32 = {k: v for k, v in params.items() if k != "head"}
    save_pytree((f32, adamw_init(f32)), str(tmp_path / "s"), 4)
    jf32 = jax.tree.map(jnp.asarray, {k: v for k, v in tree.items()
                                      if k != "head"})
    (jp, jo), _ = jckpt.restore_pytree((jf32, jadamw_init(jf32)),
                                       str(tmp_path / "s"))
    assert int(jo.step) == 0
    np.testing.assert_array_equal(np.asarray(jp["layers"]["wq"]),
                                  tree["layers"]["wq"])


def test_port_restores_a_reference_checkpoint(tmp_path):
    tree = _params(1)
    jckpt.save_pytree(jax.tree.map(jnp.asarray, tree), str(tmp_path), 8)
    like = jax.tree.map(lambda a: torch.zeros(a.shape), tree)
    got, step = restore_pytree(like, str(tmp_path))
    assert step == 8 and got["head"].dtype == torch.bfloat16
    want = _torch_tree(tree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b), jax.tree_util.keystr(path)


# --------------------------------------------------------------------------- #
# fault-tolerant loop (copies of the reference's cases)
# --------------------------------------------------------------------------- #
def _counting_step(fail_at=None, fail_times=1, calls=None, failures=None):
    """A step_fn raising the transient error ``fail_times`` times at step
    ``fail_at``, succeeding otherwise."""
    calls = calls if calls is not None else []
    failures = failures if failures is not None else []

    def step_fn(state, batch):
        step = int(state["step"])
        calls.append(step)
        if step == fail_at and failures.count(step) < fail_times:
            failures.append(step)
            raise TRANSIENT("injected transient fault")
        return {"step": state["step"] + 1}, {"loss": 0.0}

    return step_fn, calls, failures


def test_transient_fault_retried_in_place(tmp_path):
    step_fn, calls, failures = _counting_step(fail_at=2, fail_times=1)
    ft = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                  max_step_retries=2)
    state, last, _ = run_training(step_fn, {"step": torch.tensor(0)},
                                  lambda s: {}, ft=ft, num_steps=4)
    assert int(state["step"]) == 4 and last == 4
    assert calls == [0, 1, 2, 2, 3]
    assert failures == [2]


def test_persistent_fault_force_saves_then_raises(tmp_path):
    step_fn, calls, _ = _counting_step(fail_at=2, fail_times=99)
    ft = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                  max_step_retries=2)
    with pytest.raises(TRANSIENT):
        run_training(step_fn, {"step": torch.tensor(0)}, lambda s: {},
                     ft=ft, num_steps=4)
    assert calls.count(2) == 3
    assert latest_step(str(tmp_path)) == 2


def test_other_errors_are_not_retried(tmp_path):
    calls = []

    def step_fn(state, batch):
        calls.append(int(state["step"]))
        raise RuntimeError("not transient")

    ft = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=100)
    with pytest.raises(RuntimeError, match="not transient"):
        run_training(step_fn, {"step": torch.tensor(0)}, lambda s: {},
                     ft=ft, num_steps=4)
    assert calls == [0] and latest_step(str(tmp_path)) is None


def test_straggler_watch_event_contents():
    w = StragglerWatch(factor=3.0)
    for step in range(5):
        assert not w.observe(step, 1.0)
    assert w.observe(5, 10.0)
    assert not w.observe(6, 1.1)
    assert len(w.events) == 1
    step, seconds, median = w.events[0]
    assert step == 5 and seconds == 10.0 and median == 1.0


def test_straggler_watch():
    w = StragglerWatch(factor=3.0)
    for s in range(6):
        assert not w.observe(s, 1.0)
    assert w.observe(6, 10.0)
    assert len(w.events) == 1


def test_straggler_callback_fires(tmp_path):
    step_fn, _, _ = _counting_step()
    ft = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=100)
    events = []
    _, _, watch_events = run_training(
        step_fn, {"step": torch.tensor(0)}, lambda s: {}, ft=ft,
        num_steps=8, on_straggler=lambda step, dt: events.append(step))
    assert events == [s for s, *_ in watch_events]


def test_resume_restarts_at_checkpoint_step_plus_one(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1)
    mgr.maybe_save({"step": torch.tensor(4)}, 3, force=True)
    step_fn, calls, _ = _counting_step()
    ft = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=100)
    state, last, _ = run_training(step_fn, {"step": torch.tensor(0)},
                                  lambda s: {}, ft=ft, num_steps=6)
    assert calls == [4, 5]
    assert int(state["step"]) == 6 and last == 6


def test_run_training_resumes(tmp_path):
    calls = []

    def step_fn(state, batch):
        calls.append(int(state["step"]))
        return {"step": state["step"] + 1}, {"loss": 0.0}

    ft = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=2)
    state, last, _ = run_training(step_fn, {"step": torch.tensor(0)},
                                  lambda s: {}, ft=ft, num_steps=5)
    assert int(state["step"]) == 5
    calls.clear()
    state2, last2, _ = run_training(step_fn, {"step": torch.tensor(0)},
                                    lambda s: {}, ft=ft, num_steps=8)
    assert calls[0] == 5
    assert int(state2["step"]) == 8


def test_single_signal_finishes_step_and_checkpoints(tmp_path):
    calls = []

    def step_fn(state, batch):
        step = int(state["step"])
        calls.append(step)
        if step == 1:
            signal.raise_signal(signal.SIGINT)
        return {"step": state["step"] + 1}, {}

    ft = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=100)
    state, last, _ = run_training(step_fn, {"step": torch.tensor(0)},
                                  lambda s: {}, ft=ft, num_steps=10)
    assert calls == [0, 1]
    assert int(state["step"]) == 2
    assert latest_step(str(tmp_path)) == 1


def test_guard_restores_handlers_after_first_signal():
    before = signal.getsignal(signal.SIGINT)
    with PreemptionGuard() as g:
        assert signal.getsignal(signal.SIGINT) == g._handler
        signal.raise_signal(signal.SIGINT)
        assert g.requested
        assert signal.getsignal(signal.SIGINT) == before
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGINT)
    assert signal.getsignal(signal.SIGINT) == before


def test_double_signal_force_saves_and_raises(tmp_path):
    def step_fn(state, batch):
        step = int(state["step"])
        if step == 2:
            signal.raise_signal(signal.SIGINT)
            signal.raise_signal(signal.SIGINT)
        return {"step": state["step"] + 1}, {}

    ft = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=100)
    with pytest.raises(KeyboardInterrupt):
        run_training(step_fn, {"step": torch.tensor(0)}, lambda s: {},
                     ft=ft, num_steps=10)
    assert latest_step(str(tmp_path)) == 2
    assert signal.getsignal(signal.SIGINT) == signal.default_int_handler


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
ARGV = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--batch",
        "2", "--seq", "32", "--lr", "1e-2", "--ckpt-every", "2"]


def test_launch_train_twice_resumes(tmp_path, capsys):
    """Six steps checkpoint at 2 and 4; a second run to ten resumes at 5
    from the checkpoint, and its first loss is the first run's loss at
    step 5 bit for bit (same state, same batch, same arithmetic on the
    CPU), though its schedule differs after (total steps 10, not 6)."""
    ck = str(tmp_path / "ck")
    first = launch_train.main(ARGV + ["--steps", "6", "--ckpt-dir", ck])
    assert first["steps"] == list(range(6)) and first["last"] == 6
    assert first["losses"][-1] < first["losses"][0]
    assert latest_step(ck) == 4
    second = launch_train.main(ARGV + ["--steps", "10", "--ckpt-dir", ck])
    assert second["steps"] == list(range(5, 10)) and second["last"] == 10
    assert second["losses"][0] == first["losses"][5]
    out = capsys.readouterr().out
    assert out.count("[train] done at step") == 2
    assert "  step    5 loss" in out
    params, opt = second["state"]
    assert int(opt.step) == 10 and params["embed"].dtype == torch.float32


def test_launch_train_refuses_model_parallel(tmp_path):
    """``--model-parallel`` trains every family at a world that divides
    its heads (tests/test_torch_tp_train.py,
    tests/test_torch_tp_train_families.py,
    tests/test_torch_tp_train_hybrid_media.py); the launcher refuses any
    world a rank's cut would refuse, before a rank starts: 3 ranks for the
    reduced qwen2 (its 4 query heads take the uneven head cut, but 3 do
    not divide its d_ff of 128).  zamba2, whose training is ported (item
    5.7), trains at 2: its loss falls over 3 steps of gloo ranks."""
    with pytest.raises(ValueError, match="do not divide"):
        launch_train.main(ARGV + ["--steps", "2", "--ckpt-dir",
                                  str(tmp_path), "--model-parallel", "3"])
    out = launch_train.main(ARGV[:1] + ["zamba2-2.7b"] + ARGV[2:] + [
        "--steps", "3", "--ckpt-dir", str(tmp_path / "z"),
        "--model-parallel", "2"])
    assert out["steps"] == [0, 1, 2]
    assert out["losses"][-1] < out["losses"][0]


def test_launch_train_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "1",
            "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(argv)
