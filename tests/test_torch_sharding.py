"""The port's model-level sharding layer vs the JAX reference's, on the CPU.

- ``param_specs`` (train and serve) for all eleven full-width configs on
  ``data`` x ``model`` 4x2 and 16x16 and ``pod`` x ``data`` x ``model``
  2x4x8, leaf by leaf against the reference's on a
  ``jax.sharding.AbstractMesh`` over its ``param_shapes`` (the port's
  ``registry.param_shapes`` is ``meta`` tensors; its mesh a ``meta``
  ``DeviceMesh``), with each spec's ``shard_shape`` against
  ``NamedSharding``'s; ``batch_specs``, ``cache_specs`` (batches that do
  and do not divide over the data axes) and ``default_activation_specs``
  (with ``explicit_attn_sharding`` and without ``seq_shard_activations``)
  the same way.
- The reference's own ``pick``/``dp_axes`` and ``constrain`` cases;
  ``use_mesh`` and ``activation_sharding`` nested both ways.
- ``place_``/``gather_``: parts of the reference's ``shard_shape``, each
  its own allocation, gathered back bitwise.
- The explicit regions on a CPU ``DeviceMesh``: ``moe_mlp``'s per-data-rank
  dispatch and combine, and ``ssm._shift``'s halo exchange, bitwise their
  mesh-free forms (values and gradients); ``ring_scan_carry`` within 1e-6
  of a sequential scan, ``overlap`` both ways.
- The reference's sharded forwards, run once in a subprocess with 8 forced
  host devices on a 2x4 mesh with ``AxisType.Auto`` axes (under jax 0.9.0
  ``jax.make_mesh`` defaults to explicit axes, which
  ``with_sharding_constraint`` refuses): REDUCED phi3.5-moe through its
  ``shard_map`` dispatch, and REDUCED rwkv6 with and without the halo
  shift; the port's meshed forwards on the same weights within
  rtol = atol = 1e-4 (the families' tests' bar against the reference's
  mesh-free forward; the reference's sharded MoE forward itself sits
  ~2e-5 from its mesh-free one).
- The engine's ring decode (``PagedModel(mesh=)``) on REDUCED occamy-gptj,
  fp32: token streams equal to the reference engine's, with and without
  preemption, on ``RingMesh(4)`` and on a ``data`` x ``model`` mesh; with
  the scheduler's global page ids passed straight to ``ring_decode`` (as
  the reference's engine passes them) an id falls outside its rank's
  slab of the pool and the paged decode raises.
"""
import collections
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import all_arch_ids  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config  # noqa: E402
from repro_torch.models import hybrid, moe, multimodal, registry, ssm, transformer  # noqa: E402
from repro_torch.parallel import collectives, sharding  # noqa: E402
from repro_torch.parallel.mesh import DeviceMesh, RingMesh  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"4x2": {"data": 4, "model": 2}, "16x16": {"data": 16, "model": 16},
          "2x4x8": {"pod": 2, "data": 4, "model": 8}}
ARCHS = sorted(all_arch_ids())
REF_TIMEOUT = 300
TOL = dict(rtol=1e-4, atol=1e-4)


def _abstract(shape):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _meta_mesh(shape):
    return DeviceMesh(shape, device="meta")


def _flat(tree, prefix=""):
    """{"/"-joined dict path: leaf} over nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _jspecs(tree):
    """The reference's spec tree as {path: tuple of entries}."""
    return {k: tuple(v) for k, v in _flat(jax.tree.map(
        lambda s: s, tree, is_leaf=lambda x: isinstance(x, JP))).items()}


def _tspecs(tree):
    return {k: tuple(v) for k, v in _flat(tree).items()}


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    return jregistry.param_shapes(jax_get_config(arch))


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def hints(monkeypatch):
    """By kind, the ``constrain`` calls whose active spec fits the
    tensor's rank (the hints the reference applies), seen at every call
    site: ``sharding.constrain`` and the models' imported names wrapped."""
    seen = collections.Counter()
    real = sharding.constrain

    def counting(x, kind):
        active = sharding._ACTIVE
        spec = None if active is None else active.get(kind)
        if spec is not None and len(getattr(spec, "spec", spec)) <= x.ndim:
            seen[kind] += 1
        return real(x, kind)

    for mod in (sharding, transformer, ssm, hybrid, multimodal, moe):
        monkeypatch.setattr(mod, "constrain", counting)
    return seen


# ---------------------------------------------------------------------------
# the rules, spec for spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    tree, jtree = registry.param_shapes(cfg), _ref_param_shapes(arch)
    shapes = {k: tuple(v.shape) for k, v in _flat(tree).items()}
    assert shapes == {k: tuple(v.shape) for k, v in _flat(jtree).items()}
    assert all(v.device.type == "meta" for v in _flat(tree).values())
    for name, shape in MESHES.items():
        am, tm = _abstract(shape), _meta_mesh(shape)
        for mode in ("train", "serve"):
            want = jsh.param_specs(jcfg, jtree, am, mode)
            got = sharding.param_specs(cfg, tree, tm, mode)
            assert _tspecs(got) == _jspecs(want), (name, mode)
            named = _flat(sharding.named(tm, got))
            for path, spec in _flat(jax.tree.map(lambda s: s, want,
                                                 is_leaf=lambda x: isinstance(x, JP))).items():
                assert named[path].shard_shape(shapes[path]) == \
                    JNamedSharding(am, spec).shard_shape(shapes[path]), (name, mode, path)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_cache_specs_match_reference(mesh):
    shape = MESHES[mesh]
    am, tm = _abstract(shape), _meta_mesh(shape)
    for arch in ARCHS:
        cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch, reduced=True)
        for B in (1, 3, 8, 64):
            for kind in ("train_4k", "decode_32k"):
                jshape = dataclasses.replace(JSHAPES[kind], global_batch=B, seq_len=128)
                tshape = dataclasses.replace(SHAPES[kind], global_batch=B, seq_len=128)
                jb = jregistry.input_specs(jcfg, jshape)
                tb = {k: _meta(s, dt) for k, (s, dt) in registry.input_specs(cfg, tshape).items()}
                assert _tspecs(sharding.batch_specs(cfg, tb, tm)) == \
                    _jspecs(jsh.batch_specs(jcfg, jb, am)), (arch, B, kind)
            for S in (32, 128, 130):
                jc = jregistry.cache_spec(jcfg, B, S)
                tc = {k: _meta(s, dt) for k, (s, dt) in registry.cache_spec(cfg, B, S).items()}
                assert _tspecs(sharding.cache_specs(cfg, tc, tm)) == \
                    _jspecs(jsh.cache_specs(jcfg, jc, am)), (arch, B, S)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_specs_match_reference(mesh):
    shape = MESHES[mesh]
    am, tm = _abstract(shape), _meta_mesh(shape)
    for arch in ARCHS:
        for explicit in (False, True):
            for seq_shard in (True, False):
                kw = dict(explicit_attn_sharding=explicit, seq_shard_activations=seq_shard)
                cfg, jcfg = get_config(arch).replace(**kw), jax_get_config(arch).replace(**kw)
                for kind in ("train", "prefill", "decode"):
                    want = jsh.default_activation_specs(jcfg, am, kind)
                    got = sharding.default_activation_specs(cfg, tm, kind)
                    assert got.pop("__mesh__") is tm and want.pop("__mesh__") is am
                    assert {k: tuple(v.spec) for k, v in got.items()} == \
                        {k: tuple(v.spec) for k, v in want.items()}, (arch, kw, kind)
                    assert all(v.mesh is tm for v in got.values())


def test_pick_dp_axes_and_axis_size():
    """The reference's ``test_dp_axes_and_pick`` cases, on its FakeMesh."""

    class FakeMesh:
        shape = {"data": 16, "model": 16}
        axis_names = ("data", "model")

    m = FakeMesh()
    for mod in (jsh, sharding):
        assert mod.pick(m, 32, "model") == "model"
        assert mod.pick(m, 20, "model") is None  # 20 heads on 16-way TP -> replicate
        assert mod.pick(m, 20, "model", ("data",)) is None
        assert mod.pick(m, 512, ("data", "model")) == ("data", "model")
        assert mod.pick(m, 48, None, ("data", "model"), "data") == "data"
        assert mod.dp_axes(m) == ("data",)
        assert mod.axis_size(m, None) == 1 and mod.axis_size(m, ("data", "model")) == 256
    three = _meta_mesh(MESHES["2x4x8"])
    assert sharding.dp_axes(three) == jsh.dp_axes(_abstract(MESHES["2x4x8"])) == ("pod", "data")
    assert sharding.pick(three, 12, sharding.dp_axes(three), ("data",)) == ("data",)
    assert sharding.P(("data",), ("pod", "data"), None) == tuple(JP(("data",), ("pod", "data"), None))


def test_constrain_is_identity_and_counts_the_hints_that_fit(hints):
    x = torch.ones(4, 4)
    assert sharding.constrain(x, "residual") is x  # the reference's no-context case
    m = DeviceMesh({"data": 2, "model": 2}, device="cpu")
    cfg = get_config("gemma-2b")
    with sharding.activation_sharding(sharding.default_activation_specs(cfg, m, "train")):
        assert sharding.current_mesh() is m
        assert sharding.constrain(x, "residual") is x  # 3 entries > rank 2: skipped
        y = torch.ones(2, 4, 6)
        assert sharding.constrain(y, "residual") is y and sharding.constrain(y, "logits") is y
        assert sharding.constrain(y, "attn_q") is y  # no such key without explicit_attn_sharding
    assert dict(hints) == {"residual": 1, "logits": 1}
    with sharding.use_mesh(m):
        assert sharding.constrain(y, "residual") is y
    assert dict(hints) == {"residual": 1, "logits": 1}


@pytest.mark.parametrize("outer", ["use_mesh", "activation_sharding"])
def test_use_mesh_and_activation_sharding_nest(outer):
    """``activation_sharding`` replaces the whole dict (an outer kernel
    mesh is gone inside it); ``use_mesh`` adds only the kernel key (an
    outer model mesh stays); each restores on exit, as in the reference."""
    m1, m2 = object(), object()
    cfg = get_config("gemma-2b", reduced=True)
    for sh in (jsh, sharding):
        specs = {"__mesh__": m2}
        if outer == "use_mesh":
            with sh.use_mesh(m1):
                with sh.activation_sharding(specs):
                    assert sh.current_mesh() is m2 and sh.kernel_mesh() is None
                assert sh.kernel_mesh() is m1 and sh.current_mesh() is None
        else:
            with sh.activation_sharding(specs):
                with sh.use_mesh(m1):
                    assert sh.current_mesh() is m2 and sh.kernel_mesh() is m1
                assert sh.kernel_mesh() is None and sh.current_mesh() is m2
        assert sh.kernel_mesh() is None and sh.current_mesh() is None
    m = DeviceMesh({"data": 2, "model": 2}, device="cpu")
    with sharding.use_mesh(m), sharding.activation_sharding(
            sharding.default_activation_specs(cfg, m, "train")):
        assert sharding.current_mesh() is m and sharding.kernel_mesh() is None


def test_place_and_gather_parts_have_the_reference_shard_shapes():
    cfg = get_config("phi3.5-moe-42b-a6.6b", reduced=True)
    shape = {"data": 2, "model": 2}
    m, am = DeviceMesh(shape, device="cpu"), _abstract(shape)
    params = transformer.init_params(cfg.replace(fsdp=True), seed=0, device="cpu")
    keep = {k: v.clone() for k, v in _flat(params).items()}
    specs = sharding.param_specs(cfg.replace(fsdp=True), params, m, "train")
    placed = sharding.place_(params, sharding.named(m, specs))
    jspecs = _jspecs(jsh.param_specs(jax_get_config("phi3.5-moe-42b-a6.6b", reduced=True).replace(
        fsdp=True), _ref_param_shapes_reduced("phi3.5-moe-42b-a6.6b"), am, "train"))
    assert any(len(set(s) - {None}) >= 2 for s in jspecs.values())  # some leaves split both ways
    for path, leaf in _flat(placed).items():
        assert isinstance(leaf, sharding.Placed) and len(leaf.parts) == m.n
        want = JNamedSharding(am, JP(*jspecs[path])).shard_shape(keep[path].shape)
        assert all(tuple(p.shape) == want for p in leaf.parts), path
        assert len({p.data_ptr() for p in leaf.parts}) == m.n  # its own allocations
        assert len(leaf.owners) * int(np.prod(want)) == keep[path].numel()
    for path, leaf in _flat(sharding.gather_(placed)).items():
        assert torch.equal(leaf, keep[path]), path


@functools.lru_cache(maxsize=None)
def _ref_param_shapes_reduced(arch):
    return jregistry.param_shapes(jax_get_config(arch, reduced=True))


# ---------------------------------------------------------------------------
# the explicit regions, bitwise their mesh-free forms
# ---------------------------------------------------------------------------


def _grads(fn, *xs):
    xs = [x.clone().requires_grad_(True) for x in xs]
    out = fn(*xs)
    out = out[0] if isinstance(out, tuple) else out
    gs = torch.autograd.grad((out.float() * torch.linspace(-1, 1, out.numel()).reshape(
        out.shape)).sum(), xs)
    return out.detach(), gs


@pytest.mark.parametrize("shape", [{"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2}],
                         ids=["2x2", "2x2x2"])
def test_moe_mesh_branch_is_bitwise_the_mesh_free_one(shape):
    cfg = get_config("phi3.5-moe-42b-a6.6b", reduced=True)
    m = DeviceMesh(shape, device="cpu")
    lp = transformer._layer(transformer.init_params(cfg, seed=1, device="cpu"), 0)
    n_dp = sharding.axis_size(m, sharding.dp_axes(m))
    x = torch.randn(2 * n_dp, 12, cfg.d_model, generator=torch.Generator().manual_seed(0))
    want, gwant = _grads(lambda x: moe.moe_mlp(lp, x, cfg), x)
    moe.MESH_ROW_CALLS.clear()
    with sharding.activation_sharding(sharding.default_activation_specs(cfg, m, "train")):
        got, ggot = _grads(lambda x: moe.moe_mlp(lp, x, cfg), x)
        assert dict(moe.MESH_ROW_CALLS) == {"dispatch": n_dp, "combine": n_dp}
        odd, _ = _grads(lambda x: moe.moe_mlp(lp, x, cfg), x[:3])  # 3 rows do not split
    assert dict(moe.MESH_ROW_CALLS) == {"dispatch": n_dp, "combine": n_dp}
    assert torch.equal(got, want) and torch.equal(ggot[0], gwant[0])
    assert torch.equal(odd, moe.moe_mlp(lp, x[:3], cfg)[0].detach())


def test_halo_shift_is_bitwise_the_plain_shift():
    cfg = get_config("rwkv6-3b", reduced=True).replace(halo_shift=True)
    m = DeviceMesh({"data": 2, "model": 4}, device="cpu")
    x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator().manual_seed(0))
    want, gwant = _grads(lambda x: ssm._shift(x), x)
    with sharding.activation_sharding(sharding.default_activation_specs(cfg, m, "train")):
        got, ggot = _grads(lambda x: ssm._shift(x, cfg), x)
        odd = ssm._shift(x[:, :14], cfg)  # 14 does not split over 4: the plain shift
    assert torch.equal(got, want) and torch.equal(ggot[0], gwant[0])
    assert torch.equal(odd, ssm._shift(x[:, :14]))
    assert torch.equal(got[:, 0], torch.zeros_like(got[:, 0]))
    assert torch.equal(got[:, 4], x[:, 3])  # a chunk boundary: the halo column


def test_forward_on_the_mesh_is_bitwise_the_unsharded_one(hints):
    batch = registry.make_batch(get_config("rwkv6-3b", reduced=True), SHAPES["train_4k"],
                                batch_override=2, seq_override=16, device="cpu")
    m = DeviceMesh({"data": 2, "model": 4}, device="cpu")
    for arch, kw in (("rwkv6-3b", dict(halo_shift=True)), ("phi3.5-moe-42b-a6.6b", {})):
        cfg = get_config(arch, reduced=True).replace(**kw)
        params = registry.init_params(cfg, seed=0, device="cpu")
        with torch.no_grad():
            want = registry.forward(params, cfg, batch)
            hints.clear()
            with sharding.activation_sharding(sharding.default_activation_specs(cfg, m, "train")):
                got = registry.forward(params, cfg, batch)
        assert torch.equal(got[0], want[0]) and float(got[1]) == float(want[1])
        nl = cfg.num_layers
        assert hints["residual"] == nl + 1 and hints["logits"] == 1


@pytest.mark.parametrize("overlap", [True, False])
def test_ring_scan_carry_matches_a_sequential_scan(overlap):
    """The reference's own check (``tests/test_partition.py``: a running
    prefix sum over 4 chunks on ``data``), and a decaying state on each
    ``model`` ring of a 2x4 mesh."""
    m = RingMesh(4, device="cpu")
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32))

    def chunk(me, s, x):
        ys = s + torch.cumsum(x[0], 0)
        return ys[-1], ys[None]

    ys, s = collectives.ring_scan_carry(chunk, [xs[r: r + 1] for r in range(4)],
                                        torch.tensor(0.0), m, "data", overlap=overlap)
    want = torch.cumsum(xs.reshape(-1), 0).reshape(4, 4)
    torch.testing.assert_close(torch.cat(ys), want, rtol=0, atol=1e-6)
    torch.testing.assert_close(s[-1], want[-1, -1], rtol=0, atol=1e-6)

    m2 = DeviceMesh({"data": 2, "model": 4}, device="cpu")
    x = torch.randn(2, 32, 3, generator=torch.Generator().manual_seed(1))
    decay = 0.9

    def scan(me, s, xl):
        out = []
        for t in range(xl.shape[1]):
            s = decay * s + xl[:, t]
            out.append(s)
        return s, torch.stack(out, 1)

    spec = ("data", "model")  # a batch row a data rank, its sequence over model
    ys, ss = collectives.ring_scan_carry(scan, m2.shard_spec(x, spec), torch.zeros(1, 3), m2,
                                         "model", overlap=overlap)
    got = m2.gather_spec(ys, spec)
    for b in range(2):
        s_end, seq = scan(0, torch.zeros(1, 3), x[b: b + 1])
        torch.testing.assert_close(got[b: b + 1], seq, rtol=0, atol=1e-6)
        torch.testing.assert_close(ss[m2.rank({"data": b, "model": 3})], s_end, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the reference's sharded forwards (one subprocess, 8 host devices)
# ---------------------------------------------------------------------------

_REF = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import AxisType
    from repro.configs.base import SHAPES, get_config
    from repro.models import registry
    from repro.parallel import sharding as sh

    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, halo in (("phi3.5-moe-42b-a6.6b", False), ("rwkv6-3b", False), ("rwkv6-3b", True)):
        cfg = get_config(arch, reduced=True).replace(halo_shift=halo)
        params = registry.init_params(cfg, jax.random.PRNGKey(0))
        batch = registry.make_batch(cfg, SHAPES["train_4k"], batch_override=4, seq_override=16)
        with sh.activation_sharding(sh.default_activation_specs(cfg, mesh, "train")):
            logits, aux = jax.jit(lambda p, b: registry.forward(p, cfg, b))(params, batch)
        out[f"{arch}/{halo}/logits"] = np.asarray(logits)
        out[f"{arch}/{halo}/aux"] = np.asarray(aux)
        out[f"{arch}/tokens"] = np.asarray(batch["tokens"])
        leaves, _ = jax.tree_util.tree_flatten_with_path(params)
        for path, leaf in leaves:
            out[f"{arch}/params/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
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


def run_reference(script, path):
    """``script`` in a subprocess with the reference importable, writing
    ``path``; its own time limit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script, str(path)], capture_output=True,
                          text=True, env=env, timeout=REF_TIMEOUT)
    assert proc.returncode == 0 and "RESULT:ok" in proc.stdout, proc.stderr[-3000:]
    return np.load(path)


@pytest.fixture(scope="module")
def ref_forwards(tmp_path_factory):
    return run_reference(_REF, tmp_path_factory.mktemp("ref") / "forwards.npz")


@pytest.mark.parametrize("arch,halo", [("phi3.5-moe-42b-a6.6b", False), ("rwkv6-3b", False),
                                       ("rwkv6-3b", True)])
def test_sharded_forward_matches_the_reference_sharded_run(ref_forwards, arch, halo):
    cfg = get_config(arch, reduced=True).replace(halo_shift=halo)
    params = transformer.params_from_jax(_nest(ref_forwards, f"{arch}/params/"), device="cpu")
    batch = {"tokens": torch.from_numpy(ref_forwards[f"{arch}/tokens"])}
    m = DeviceMesh({"data": 2, "model": 4}, device="cpu")
    moe.MESH_ROW_CALLS.clear()
    with torch.no_grad(), sharding.activation_sharding(
            sharding.default_activation_specs(cfg, m, "train")):
        logits, aux = registry.forward(params, cfg, batch)
    assert dict(moe.MESH_ROW_CALLS) == ({"dispatch": 2 * cfg.num_layers,
                                         "combine": 2 * cfg.num_layers}
                                        if cfg.num_experts else {})
    np.testing.assert_allclose(logits.numpy(), ref_forwards[f"{arch}/{halo}/logits"], **TOL)
    np.testing.assert_allclose(float(aux), float(ref_forwards[f"{arch}/{halo}/aux"]), **TOL)


# ---------------------------------------------------------------------------
# the engine's ring decode
# ---------------------------------------------------------------------------


def _requests(mod):
    rng = np.random.default_rng(7)
    return [mod.Request(rid=rid,
                        prompt=tuple(int(x) for x in rng.integers(1, 512, int(rng.integers(3, 8)))),
                        max_new_tokens=6, arrival=rid // 2)
            for rid in range(5)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    out = eng.run(max_steps=500)
    assert eng.leaked_blocks() == 0
    return out, sum(1 for e in eng.scheduler.events if e[0] == "preempt")


GEOMETRY = dict(block_size=4, max_slots=3, max_blocks_per_seq=4)


@pytest.fixture(scope="module")
def gptj():
    jcfg = jax_get_config("occamy-gptj", reduced=True)
    np_params = jax.tree.map(np.asarray, jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    return (jcfg, get_config("occamy-gptj", reduced=True), np_params,
            transformer.params_from_jax(np_params, device="cpu"))


@pytest.mark.parametrize("num_blocks", [8, 40], ids=["tight", "roomy"])
def test_ring_engine_streams_match_the_reference_engine(gptj, num_blocks):
    jcfg, cfg, np_params, params = gptj
    want, jpre = _serve(jeng.ServingEngine.with_model(
        jcfg, jax.tree.map(jax.numpy.asarray, np_params), num_blocks=num_blocks, **GEOMETRY),
        _requests(jeng))
    calls = []
    real = teng.ring_decode.ring_decode

    def counted(*a, **k):
        calls.append(a[5].n)
        return real(*a, **k)

    teng.ring_decode.ring_decode = counted
    try:
        for mesh in (RingMesh(4, device="cpu"), DeviceMesh({"data": 2, "model": 2}, device="cpu")):
            calls.clear()
            got, pre = _serve(teng.ServingEngine.with_model(
                cfg, params, num_blocks=num_blocks, device="cpu", mesh=mesh, **GEOMETRY),
                _requests(teng))
            assert got == want and pre == jpre and (pre > 0) == (num_blocks == 8)
            assert calls and set(calls) == {mesh.shape["data"]}
            assert len(calls) % cfg.num_layers == 0
    finally:
        teng.ring_decode.ring_decode = real


def test_ring_engine_without_the_page_gather_fails(gptj):
    """The reference's engine hands ``ring_decode`` the scheduler's global
    page ids, where its contract wants each rank's local ids. Passed
    through so (the reference's ``attn_fn``), an id past a rank's slab of
    the pool reaches the paged decode: the port's raises, the reference's
    gather clamps it and its streams leave the unsharded engine's. The
    engine's per-call page gather is what keeps the contract."""
    _, cfg, _, params = gptj
    ring = RingMesh(4, device="cpu")
    eng = teng.ServingEngine.with_model(cfg, params, num_blocks=40, device="cpu", mesh=ring,
                                        **GEOMETRY)

    def global_ids(q, kp, vp, ks, vs, tbl, pos, window):
        return teng.ring_decode.ring_decode(q, kp, vp, tbl, pos, ring, window=window,
                                            k_scale=ks, v_scale=vs)

    eng.model.attn_fn = global_ids
    with pytest.raises(IndexError):
        _serve(eng, _requests(teng))


def test_ring_engine_needs_divisible_pools(gptj):
    _, cfg, _, params = gptj
    with pytest.raises(ValueError, match="divisible by the data axis"):
        teng.PagedModel(cfg, params, num_blocks=10, device="cpu", mesh=RingMesh(4, device="cpu"),
                        **GEOMETRY)
