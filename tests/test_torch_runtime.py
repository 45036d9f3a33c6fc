"""The port's training runtime vs the JAX reference on the CPU: twins of
``tests/test_runtime.py`` and ``tests/test_system.py::
test_training_reduces_loss``, the launcher, and the slice as a whole.

- Checkpoints round-trip bitwise (bf16 leaves as their uint16 bits,
  ``EllMatrix`` and ``BsrMatrix`` leaves), and a checkpoint written by
  ``repro.runtime.checkpoint.save`` restores into the port bitwise.
- Crash and restart resume at the checkpoint's step and data position; a
  restarted run ends at the straight run's loss (``rtol = 1e-4``, the
  reference's bar); microbatched gradients equal the full batch's
  (``rtol = atol = 1e-3``, the reference's bar); compression still
  descends; gemma-2b REDUCED loses more than 0.1 in 30 steps.
- ``launch.train.main`` on the CPU exits 42 at an injected crash, then
  resumes, also onto a ``--mesh``; ``run_training(mesh=)`` on a 2x1 CPU
  ``DeviceMesh`` gives the unsharded run's losses within 1e-4.
- ``run_training`` of the port and of the reference, 5 steps from the same
  initial state (``state_from_jax``) on the same data stream: each step's
  loss within ``rtol = 1e-4, atol = 1e-5`` (occamy-gptj) or ``1e-3``
  (hymba, the scan in the path), and every final parameter within the sum
  of the 5 steps' learning rates (an Adam step moves a weight by about lr
  at most, so a sign flip on a near-zero gradient stays inside it).
- ``core.pipeline``'s ``tiled_map``/``tiled_gemm`` against the
  reference's on the same operands.
"""
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core import pipeline as jpipeline  # noqa: E402
from repro.core import sparse as jsparse  # noqa: E402
from repro.runtime import checkpoint as jckpt  # noqa: E402
from repro.runtime import train_loop as jtrain_loop  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config  # noqa: E402
from repro_torch.core import pipeline, tree  # noqa: E402
from repro_torch.core.sparse import BsrMatrix, EllMatrix, dense_to_bsr, random_ell  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch import train_llm  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.parallel.mesh import DeviceMesh  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.runtime.fault_tolerance import FailureInjector, StragglerMonitor  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("occamy-gptj", reduced=True)
QUIET = dict(log_every=100, log_fn=lambda *a: None)


def _equal_trees(a, b):
    pa, la = tree.flatten_with_paths(a)
    pb, lb = tree.flatten_with_paths(b)
    assert pa == pb
    for p, x, y in zip(pa, la, lb):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y), p


def _sparse_state():
    rng = np.random.default_rng(0)
    ell = random_ell(rng, R=32, C=64, density=0.25)
    dense = torch.zeros(16, 256)
    dense[:8, :128] = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
    return ell, dense_to_bsr(dense, bm=8, bk=128)


def test_checkpoint_roundtrip_with_bf16_and_sparse_leaves(tmp_path):
    state = train_loop.init_train_state(CFG, 0, device="cpu")
    ell, bsr = _sparse_state()
    state["extra"] = {"adjacency": ell, "weights": bsr,
                      "half": torch.randn(3, 5).to(torch.bfloat16)}
    path = ckpt.save(str(tmp_path), 7, state)
    assert os.path.isdir(path) and ckpt.latest_step(str(tmp_path)) == 7
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    assert manifest["dtypes"]["extra/half"] == "bfloat16"
    assert "params/layers/wq" in manifest["keys"] and "opt/step" in manifest["keys"]
    with np.load(Path(path) / "arrays.npz") as data:
        assert data["extra/half"].dtype == np.uint16
        assert sorted(data.files) == manifest["keys"]
    restored = ckpt.restore(str(tmp_path), 7, state)
    _equal_trees(state, restored)
    assert isinstance(restored["extra"]["adjacency"], EllMatrix)
    assert isinstance(restored["extra"]["weights"], BsrMatrix)
    assert restored["extra"]["weights"].shape == bsr.shape
    assert torch.equal(restored["extra"]["adjacency"].todense(), ell.todense())
    assert torch.equal(restored["extra"]["weights"].todense(), bsr.todense())
    t = ckpt.save_async(str(tmp_path), 9, state)
    t.join(timeout=60)
    assert not t.is_alive() and ckpt.latest_step(str(tmp_path)) == 9
    _equal_trees(state, ckpt.restore(str(tmp_path), 9, state))


def test_restore_reads_a_reference_checkpoint_bitwise(tmp_path):
    jcfg = jax_get_config("occamy-gptj", reduced=True)
    jstate = jtrain_loop.init_train_state(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    jstate["extra"] = {
        "adjacency": jsparse.random_ell(rng, R=16, C=32, density=0.25),
        "half": jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16),
    }
    jckpt.save(str(tmp_path), 3, jstate)
    np_state = jax.tree.map(np.asarray, {k: jstate[k] for k in ("params", "opt")})
    like = train_loop.state_from_jax(np_state, device="cpu")
    ell = jstate["extra"]["adjacency"]
    like["extra"] = {"adjacency": EllMatrix(torch.zeros(16, 8), torch.zeros(16, 8, dtype=torch.int32),
                                            (16, 32)),
                     "half": torch.zeros(4, 6, dtype=torch.bfloat16)}
    got = ckpt.restore(str(tmp_path), 3, like)
    _, jl = tree.flatten_with_paths(got)
    want = jax.tree.leaves(jstate)
    assert len(jl) == len(want)
    for g, w in zip(jl, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if str(w.dtype) == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got["extra"]["adjacency"].todense().numpy(),
                                  np.asarray(ell.todense()))


def test_crash_restart_resumes_and_finishes(tmp_path):
    kw = dict(num_steps=8, batch_override=2, seq_override=16, ckpt_dir=str(tmp_path),
              ckpt_every=3, device="cpu", **QUIET)
    with pytest.raises(RuntimeError, match="injected crash at step 5"):
        train_loop.run_training(CFG, SHAPES["train_4k"],
                                failure_injector=FailureInjector({5: "crash"}), **kw)
    assert ckpt.latest_step(str(tmp_path)) == 3
    state, losses, _ = train_loop.run_training(CFG, SHAPES["train_4k"], **kw)
    assert len(losses) == 8 - 3
    assert int(state["opt"]["step"]) == 8
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_restarted_run_matches_uninterrupted(tmp_path):
    kw = dict(num_steps=6, batch_override=2, seq_override=16, device="cpu", **QUIET)
    _, straight, _ = train_loop.run_training(CFG, SHAPES["train_4k"], **kw)
    with pytest.raises(RuntimeError):
        train_loop.run_training(CFG, SHAPES["train_4k"], ckpt_dir=str(tmp_path), ckpt_every=3,
                                failure_injector=FailureInjector({4: "crash"}), **kw)
    _, resumed, _ = train_loop.run_training(CFG, SHAPES["train_4k"], ckpt_dir=str(tmp_path),
                                            ckpt_every=3, **kw)
    assert len(resumed) == 3
    np.testing.assert_allclose(straight[-1], resumed[-1], rtol=1e-4)


def test_straggler_monitor():
    m = StragglerMonitor(threshold=2.0)
    for _ in range(10):
        assert not m.observe(0.1)
    assert m.observe(0.5)
    assert m.events == 1 and not m.should_exclude
    m.observe(0.5), m.observe(0.5)
    assert m.should_exclude


def test_microbatched_grads_match_full_batch():
    params = registry.init_params(CFG, seed=0, device="cpu")
    batch = registry.make_batch(CFG, SHAPES["train_4k"], batch_override=4, seq_override=16,
                                device="cpu")
    lg = train_loop.loss_and_grads_fn(CFG)
    l_full, g_full = lg(params, batch)
    l_micro, g_micro = pipeline.microbatched(lg, 2)(params, batch)
    np.testing.assert_allclose(float(l_full), float(l_micro), rtol=1e-5)
    for a, b in zip(tree.leaves(g_full), tree.leaves(g_micro)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="split"):
        pipeline.microbatched(lg, 3)(params, batch)


def test_grad_compression_training_still_descends():
    state, losses, _ = train_loop.run_training(
        CFG, SHAPES["train_4k"], num_steps=15, batch_override=2, seq_override=16,
        grad_compression=True, device="cpu", **QUIET)
    assert losses[-1] < losses[0]
    assert tree.leaves(state["grad_err"])[0].dtype == torch.float32


def test_training_reduces_loss():
    cfg = get_config("gemma-2b", reduced=True).replace(learning_rate=3e-3, warmup_steps=5)
    _, losses, _ = train_loop.run_training(cfg, SHAPES["train_4k"], num_steps=30,
                                           batch_override=4, seq_override=32, device="cpu",
                                           **QUIET)
    assert losses[-1] < losses[0] - 0.1, (losses[0], losses[-1])


def test_launch_train_crash_exits_42_then_resumes(tmp_path, capsys):
    argv = ["--arch", "rwkv6-3b", "--reduced", "--device", "cpu", "--steps", "5",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    with pytest.raises(SystemExit) as exc:
        train.main(argv + ["--inject-crash-at", "3"])
    assert exc.value.code == train.CRASH_EXIT == 42
    state, losses, _ = train.main(argv)
    assert len(losses) == 5 - 2 and int(state["opt"]["step"]) == 5
    out = capsys.readouterr().out
    assert "[restore] resumed from step 2" in out and "done: 3 steps" in out
    # --mesh trains on a data x model mesh: from the step-4 checkpoint to 6
    state, mesh_losses, _ = train.main(argv + ["--mesh", "2x1", "--steps", "6"])
    assert len(mesh_losses) == 2 and int(state["opt"]["step"]) == 6
    assert "[restore] resumed from step 4" in capsys.readouterr().out
    mesh = DeviceMesh({"data": 2, "model": 1}, device="cpu")
    kw = dict(num_steps=2, batch_override=2, seq_override=16, **QUIET)
    _, meshed, _ = train_loop.run_training(CFG, SHAPES["train_4k"], mesh=mesh, **kw)
    _, plain, _ = train_loop.run_training(CFG, SHAPES["train_4k"], device="cpu", **kw)
    np.testing.assert_allclose(meshed, plain, rtol=1e-4, atol=1e-4)


def test_train_llm_config_is_the_examples():
    spec = importlib.util.spec_from_file_location("ex_train_llm", ROOT / "examples/train_llm.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    import dataclasses

    assert dataclasses.asdict(train_llm.CFG) == dataclasses.asdict(ex.CFG)
    assert train_llm.CKPT_EVERY == 25


@pytest.mark.parametrize("arch", ["occamy-gptj", "hymba-1.5b"])
def test_run_training_matches_reference(arch):
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    kw = dict(num_steps=5, seed=0, batch_override=2, seq_override=16, **QUIET)
    jstate, jlosses, _ = jtrain_loop.run_training(jcfg, JSHAPES["train_4k"], **kw)
    np_init = jax.tree.map(np.asarray, jtrain_loop.init_train_state(jcfg, jax.random.PRNGKey(0)))
    state, losses, _ = train_loop.run_training(
        cfg, SHAPES["train_4k"], device="cpu",
        initial_state=train_loop.state_from_jax(np_init, device="cpu"), **kw)
    tol = dict(rtol=1e-4, atol=1e-5) if cfg.family == "dense" else dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(losses, jlosses, **tol)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 5
    lr_sum = sum(cfg.learning_rate * min(s / max(cfg.warmup_steps, 1), 1.0) for s in range(1, 6))
    paths, got = tree.flatten_with_paths(state["params"])
    for p, a, b in zip(paths, got, jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=0,
                                   atol=lr_sum, err_msg=p)


def test_tiled_map_and_gemm_match_reference():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((48, 32)).astype(np.float32)
    b = rng.standard_normal((32, 24)).astype(np.float32)
    want = np.asarray(jpipeline.tiled_gemm(jnp.asarray(a), jnp.asarray(b), tile_m=16))
    got = pipeline.tiled_gemm(torch.from_numpy(a), torch.from_numpy(b), tile_m=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    x = rng.standard_normal((4, 12, 3)).astype(np.float32)
    want = np.asarray(jpipeline.tiled_map(lambda t: t * 2 + 1, jnp.asarray(x), 4, axis=1))
    got = pipeline.tiled_map(lambda t: t * 2 + 1, torch.from_numpy(x), 4, axis=1)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="does not divide"):
        pipeline.tiled_map(lambda t: t, torch.from_numpy(x), 5, axis=1)
