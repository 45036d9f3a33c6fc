"""Training on a ``data`` x ``model`` mesh (``run_training(mesh=)`` and
``launch/train.py --mesh``) vs the JAX reference's sharded run, on the CPU.

- The reference's ``run_training(cfg, shape, mesh)`` on a 4x2 mesh with
  ``AxisType.Auto`` axes (8 forced host devices, one subprocess; under
  jax 0.9.0 ``jax.make_mesh`` defaults to explicit axes, which
  ``with_sharding_constraint`` refuses), REDUCED phi3.5-moe (its
  ``shard_map`` dispatch) and rwkv6 with the halo shift, 2 steps of
  8 x 32: the port's meshed run from the same initial state
  (``state_from_jax``) on a CPU ``DeviceMesh`` of the same shape gives each
  step's loss within 1e-4, as does the port's unsharded run, and its
  final state (parameters, both moments, the step), leaf by leaf, within
  REF_STATE_GAP of the reference's and TWIN_STATE_GAP of the unsharded
  run's.
- Every rank's parts of the meshed state, replicas included, against the
  unsharded twin's: within TWIN_STATE_GAP, and past it when one rank's
  AdamW on one leaf is skipped or applied twice (which the losses of 2
  warm-up steps do not show).
- ``place_`` under ``state_shardings``: every part of the parameters and
  both moments has the reference's ``NamedSharding.shard_shape``;
  ``opt.step`` is replicated.
- A crash on the mesh resumes from its checkpoint to the straight meshed
  run's loss (1e-4); the checkpoint holds the gathered leaves, the files
  of an unsharded run, and the reference's ``checkpoint.restore`` reads
  them.
- ``pod`` x ``data`` x ``model`` with microbatches and gradient
  compression against the unsharded run: losses, the state, and the
  compression residual within RESIDUAL_GAP.
- ``launch.train.main(--mesh 2x2 --device cpu)`` exits 42 at an injected
  crash, then resumes to the straight meshed run's loss.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.runtime import checkpoint as jckpt  # noqa: E402
from repro.runtime import train_loop as jtrain_loop  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.data.synthetic import batch_at_step  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.mesh import DeviceMesh  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.runtime.fault_tolerance import FailureInjector  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
CASES = (("phi3.5-moe-42b-a6.6b", False), ("rwkv6-3b", True))  # (arch, halo_shift)
QUIET = dict(log_every=100, log_fn=lambda *a: None)
RUN = dict(batch_override=8, seq_override=32, **QUIET)
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
# the worst leaf's relative Frobenius gap (``sharding.gap``) of the meshed
# state (parameters, both moments, the step) after 2 steps: from the
# reference's sharded run's (read at most 6.8e-5, phi3.5-moe's v) and from
# the port's unsharded run's (at most 4.0e-7: the per-rank slices sum
# their gradients in another order, and the norm sums its squares in
# another order). A skipped or doubled rank update reads 0.35-0.41.
REF_STATE_GAP = 2e-4
TWIN_STATE_GAP = 2e-6
# the compression residual is the gradient's bf16 rounding error, ~2^-9 of
# the gradient, so the same last-bit gradient differences read ~1e3 times
# larger there (at most 2.6e-4)
RESIDUAL_GAP = 1e-3

_REF = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec
    from repro.configs.base import SHAPES, get_config
    from repro.parallel import sharding as sh
    from repro.runtime import train_loop

    def path_key(path):
        return "/".join(str(p.key) for p in path)

    mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, halo in (("phi3.5-moe-42b-a6.6b", False), ("rwkv6-3b", True)):
        cfg = get_config(arch, reduced=True).replace(halo_shift=halo)
        init = train_loop.init_train_state(cfg, jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(init)[0]:
            out[f"{arch}/init/{path_key(path)}"] = np.asarray(leaf)
        specs = sh.param_specs(cfg, init["params"], mesh, "train")
        is_p = lambda x: isinstance(x, PartitionSpec)
        for (path, spec), leaf in zip(jax.tree_util.tree_flatten_with_path(specs, is_leaf=is_p)[0],
                                      jax.tree.leaves(init["params"])):
            out[f"{arch}/shard_shape/{path_key(path)}"] = np.asarray(
                NamedSharding(mesh, spec).shard_shape(leaf.shape))
        final, losses, _ = train_loop.run_training(
            cfg, SHAPES["train_4k"], mesh, num_steps=2, seed=0, batch_override=8,
            seq_override=32, log_fn=lambda *a: None)
        out[f"{arch}/losses"] = np.asarray(losses)
        for path, leaf in jax.tree_util.tree_flatten_with_path(final)[0]:
            out[f"{arch}/final/{path_key(path)}"] = np.asarray(leaf)
    np.savez(sys.argv[1], **out)
    print("RESULT:ok")
    """
)


def _nest(npz, prefix):
    out = {}
    for k in npz.files:
        if k.startswith(prefix):
            *parents, leaf = k[len(prefix):].split("/")
            d = out
            for p in parents:
                d = d.setdefault(p, {})
            d[leaf] = npz[k]
    return out


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "mesh_train.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF, str(path)], capture_output=True,
                          text=True, env=env, timeout=REF_TIMEOUT)
    assert proc.returncode == 0 and "RESULT:ok" in proc.stdout, proc.stderr[-3000:]
    return np.load(path)


def _gaps(state, want):
    """{path: sharding.gap} of every leaf of ``state`` (``Placed`` parts or
    tensors) from the same path of ``want`` (global tensors)."""
    got, want = (dict(zip(*tree.flatten_with_paths(t))) for t in (state, want))
    assert sorted(got) == sorted(want)
    return {k: sharding.gap(got[k], want[k]) for k in got}


def _worst(gaps):
    return max(gaps.items(), key=lambda kv: kv[1])


def _cfg(arch, halo):
    return get_config(arch, reduced=True).replace(halo_shift=halo)


def _mesh(shape=None):
    return DeviceMesh(shape or {"data": 4, "model": 2}, device="cpu")


@pytest.mark.parametrize("arch,halo", CASES)
def test_mesh_training_matches_the_reference_sharded_run(ref_runs, arch, halo):
    cfg = _cfg(arch, halo)
    init = _nest(ref_runs, f"{arch}/init/")
    moe.MESH_ROW_CALLS.clear()
    state, losses, _ = train_loop.run_training(
        cfg, SHAPES["train_4k"], _mesh(), num_steps=2,
        initial_state=train_loop.state_from_jax(init, device="cpu"), **RUN)
    np.testing.assert_allclose(losses, ref_runs[f"{arch}/losses"], **LOSS_TOL)
    if cfg.num_experts:  # 4 data ranks, every layer, forward and remat recompute
        assert moe.MESH_ROW_CALLS["dispatch"] == 2 * 2 * 4 * cfg.num_layers
    plain_state, plain, _ = train_loop.run_training(
        cfg, SHAPES["train_4k"], num_steps=2, device="cpu",
        initial_state=train_loop.state_from_jax(init, device="cpu"), **RUN)
    np.testing.assert_allclose(losses, plain, **LOSS_TOL)
    # returned gathered, in the unsharded tree form
    assert all(isinstance(x, torch.Tensor) for x in tree.leaves(state))
    assert int(state["opt"]["step"]) == 2
    # what each rank's AdamW did: the whole state, leaf by leaf
    ref_state = train_loop.state_from_jax(_nest(ref_runs, f"{arch}/final/"), device="cpu")
    path, worst = _worst(_gaps(state, ref_state))
    assert worst <= REF_STATE_GAP, (path, worst)
    path, worst = _worst(_gaps(state, plain_state))
    assert worst <= TWIN_STATE_GAP, (path, worst)


@pytest.mark.parametrize("arch,halo", CASES)
def test_placed_parts_have_the_reference_shard_shapes(ref_runs, arch, halo):
    cfg, mesh = _cfg(arch, halo), _mesh()
    state = train_loop.state_from_jax(_nest(ref_runs, f"{arch}/init/"), device="cpu")
    want = {k: tuple(v) for k, v in zip(*tree.flatten_with_paths(
        _nest(ref_runs, f"{arch}/shard_shape/")))}
    sharding.place_(state, train_loop.state_shardings(cfg, state, mesh))
    for part in ("params", "opt/m", "opt/v"):
        sub = state
        for k in part.split("/"):
            sub = sub[k]
        paths, placed = tree.flatten_with_paths(sub)
        assert sorted(paths) == sorted(want)
        for path, leaf in zip(paths, placed):
            assert isinstance(leaf, sharding.Placed) and len(leaf.parts) == mesh.n
            assert {tuple(p.shape) for p in leaf.parts} == {want[path]}, (part, path)
    step = state["opt"]["step"]
    assert tuple(step.sharding.spec) == () and len(step.owners) == 1
    assert len({p.data_ptr() for p in step.parts}) == mesh.n


def test_mesh_crash_resumes_from_a_gathered_checkpoint(tmp_path):
    cfg = _cfg("phi3.5-moe-42b-a6.6b", False)
    shape = {"data": 2, "model": 2}
    kw = dict(num_steps=5, seed=0, **RUN)
    _, straight, _ = train_loop.run_training(cfg, SHAPES["train_4k"], _mesh(shape), **kw)
    with pytest.raises(RuntimeError, match="injected crash"):
        train_loop.run_training(cfg, SHAPES["train_4k"], _mesh(shape), ckpt_dir=str(tmp_path),
                                ckpt_every=2, failure_injector=FailureInjector({3: "crash"}), **kw)
    assert ckpt.latest_step(str(tmp_path)) == 2
    # the files of an unsharded run, which the reference reads
    plain_dir = tmp_path / "plain"
    state, _, _ = train_loop.run_training(cfg, SHAPES["train_4k"], device="cpu",
                                          ckpt_dir=str(plain_dir), ckpt_every=2,
                                          **dict(kw, num_steps=2))
    def manifest(d):
        m = json.loads((d / "step_2" / "manifest.json").read_text())
        return m["keys"], m["dtypes"], m["shapes"]

    assert manifest(tmp_path) == manifest(plain_dir)
    jcfg = jax_get_config("phi3.5-moe-42b-a6.6b", reduced=True)
    like = jtrain_loop.init_train_state(jcfg, jax.random.PRNGKey(1))
    jstate = jckpt.restore(str(tmp_path), 2, like)
    mine = ckpt.restore(str(tmp_path), 2, state)
    for (p, a), b in zip(zip(*tree.flatten_with_paths(mine)), jax.tree.leaves(jstate)):
        assert np.array_equal(a.numpy(), np.asarray(b)), p
    # resume on the mesh
    state, resumed, _ = train_loop.run_training(cfg, SHAPES["train_4k"], _mesh(shape),
                                                ckpt_dir=str(tmp_path), ckpt_every=100, **kw)
    assert len(resumed) == 3 and int(state["opt"]["step"]) == 5
    np.testing.assert_allclose(resumed[-1], straight[-1], **LOSS_TOL)


def test_three_axis_mesh_with_microbatches_and_compression():
    cfg = _cfg("phi3.5-moe-42b-a6.6b", False)
    kw = dict(num_steps=2, seed=0, microbatches=2, grad_compression=True, **RUN)
    moe.MESH_ROW_CALLS.clear()
    state, losses, _ = train_loop.run_training(
        cfg, SHAPES["train_4k"], _mesh({"pod": 2, "data": 2, "model": 2}), **kw)
    # each microbatch of 4 rows splits over pod x data: 4 ranks
    assert moe.MESH_ROW_CALLS["dispatch"] == 2 * 2 * 2 * 4 * cfg.num_layers
    plain_state, plain, _ = train_loop.run_training(cfg, SHAPES["train_4k"], device="cpu", **kw)
    np.testing.assert_allclose(losses, plain, **LOSS_TOL)
    assert set(state) == {"params", "opt", "grad_err"}
    assert all(bool(torch.isfinite(e).all()) for e in tree.leaves(state["grad_err"]))
    gaps = _gaps(state, plain_state)
    path, worst = _worst({k: v for k, v in gaps.items() if not k.startswith("grad_err/")})
    assert worst <= TWIN_STATE_GAP, (path, worst)
    path, worst = _worst({k: v for k, v in gaps.items() if k.startswith("grad_err/")})
    assert worst <= RESIDUAL_GAP, (path, worst)


@pytest.mark.parametrize("fault", [None, "skip an owner's part", "skip a replica",
                                   "apply twice"])
def test_state_gap_catches_a_wrong_per_rank_update(monkeypatch, fault):
    """Every rank's parts of the meshed state against the unsharded twin's
    after 2 steps: within TWIN_STATE_GAP, and past it when one rank's
    AdamW on one leaf is skipped (a part its rank owns, or a replica that
    the gathered state never shows) or applied twice."""
    cfg, mesh = _cfg("phi3.5-moe-42b-a6.6b", False), _mesh()
    twin = train_loop.init_train_state(cfg, 0, device="cpu")
    state = tree.tree_map(torch.clone, twin)
    sharding.place_(state, train_loop.state_shardings(cfg, state, mesh))
    paths, placed = tree.flatten_with_paths(state["params"])
    if fault == "skip a replica":
        i = next(i for i, x in enumerate(placed) if len(x.owners) < mesh.n)
        rank = next(r for r in range(mesh.n) if r not in placed[i].owners)
    else:
        i = next(i for i, x in enumerate(placed) if any(e is not None for e in x.sharding.spec))
        rank = placed[i].owners[-1]
    target, real = placed[i].parts[rank], adamw.update_leaf

    def update_leaf(c, p, *rest):
        if fault is not None and p is target:
            if fault == "apply twice":
                real(c, p, *rest)
            else:
                return
        real(c, p, *rest)

    monkeypatch.setattr(adamw, "update_leaf", update_leaf)
    plain, meshed = train_loop.make_train_step(cfg), train_loop.make_mesh_train_step(cfg, mesh)
    for step in range(2):
        batch = {k: torch.from_numpy(v) for k, v in
                 batch_at_step(cfg, SHAPES["train_4k"], 0, step, 8, 32).items()}
        twin, a = plain(twin, batch)
        _, b = meshed(state, batch)
        np.testing.assert_allclose(float(b["loss"]), float(a["loss"]), **LOSS_TOL)
    gaps = _gaps(state, twin)
    path, worst = _worst(gaps)
    if fault is None:
        assert worst <= TWIN_STATE_GAP, (path, worst)
    else:
        assert worst > TWIN_STATE_GAP and path.endswith(paths[i]), (path, worst, paths[i])


def test_launch_train_mesh_crashes_then_resumes(tmp_path, capsys):
    argv = ["--arch", "phi3.5-moe-42b-a6.6b", "--reduced", "--device", "cpu", "--steps", "4",
            "--batch", "4", "--seq", "16", "--mesh", "2x2", "--log-every", "1"]
    _, straight, _ = train.main(argv)
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    with pytest.raises(SystemExit) as exc:
        train.main(argv + ck + ["--inject-crash-at", "3"])
    assert exc.value.code == train.CRASH_EXIT
    state, resumed, _ = train.main(argv + ck)
    out = capsys.readouterr().out
    assert "[restore] resumed from step 2" in out and "done: 2 steps" in out
    assert len(straight) == 4 and int(state["opt"]["step"]) == 4
    np.testing.assert_allclose(resumed[-1], straight[-1], **LOSS_TOL)
