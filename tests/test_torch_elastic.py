"""The rest of the reference's mesh functions in the port, on the CPU:
``train_state_struct``, ``elastic_remesh`` / ``reshard_state``,
``collectives.all_to_all`` and ``ep_expert_ffn``.

- ``train_state_struct``: every leaf's shape and dtype equal to the
  reference's ``ShapeDtypeStruct`` for all eleven full-width configs.
- ``elastic_remesh`` / ``reshard_state``: the reference's own test
  (``tests/test_system.py``: gemma-2b REDUCED, 1 x 1, the state bitwise
  after the reshard), then on a 2 x 2 CPU ``DeviceMesh`` (3 data rows, one
  lost) with each leaf's spec equal to the reference's on its 2 x 2 mesh,
  the parts their specs' shard shapes and the gathered leaves bitwise; a
  reshard from one placement onto another, bitwise.
- ``all_to_all``: against ``jax.lax.all_to_all`` (untiled) over ``model``
  on a 2 x 4 mesh, rank-distinct values, every split and concat pair.
- ``ep_expert_ffn`` on a real prefill dispatch of REDUCED phi3.5-moe,
  fp32: against the reference's on a 2 x 4 mesh at one batch row per data
  rank (1e-5), and against the port's TP einsums (``models/moe.py``) on
  2 x 2 and 1 x 4 meshes with 16 and 8 experts (phi3.5-moe's and
  grok-1's counts) at several rows per data rank; the reference's return
  exchange misplaces rows there, the port's does not (a difference by
  design).

The reference's meshed runs need 8 host devices: they run once, in one
subprocess, on meshes with ``AxisType.Auto`` axes (under jax 0.9.0
``jax.make_mesh`` makes explicit ones).
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
from repro.configs.base import all_arch_ids  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro.runtime import train_loop as jtl  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe, registry  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.parallel.mesh import DeviceMesh  # noqa: E402
from repro_torch.runtime import fault_tolerance as ft  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
MOE = "phi3.5-moe-42b-a6.6b"
RESHARD_ARCHS = ("gemma-2b", MOE)
A2A_PAIRS = ((0, 0), (0, 1), (0, 2), (2, 0), (2, 1))
EP_S = 24  # prefill tokens per row of the dispatch


def _flat(tree_, prefix=""):
    if isinstance(tree_, dict):
        out = {}
        for k, v in tree_.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree_}


# ---------------------------------------------------------------------------
# train_state_struct
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(all_arch_ids()))
def test_train_state_struct_matches_the_reference(arch):
    got = _flat(train_loop.train_state_struct(get_config(arch)))
    want = {k: v for k, v in _flat(jax.tree.map(
        lambda s: s, jtl.train_state_struct(jax_get_config(arch)),
        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))).items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.device.type == "meta", k
        assert tuple(g.shape) == tuple(w.shape), k
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), k


# ---------------------------------------------------------------------------
# the reference's meshed runs (one subprocess, 8 host devices)
# ---------------------------------------------------------------------------

_REF = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.configs.base import get_config
    from repro.models import layers as L
    from repro.parallel.collectives import ep_expert_ffn
    from repro.parallel.compat import shard_map
    from repro.runtime import fault_tolerance as ft, train_loop

    out, meta = {}, {}
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    x = jnp.arange(8 * 4 * 3 * 4, dtype=jnp.float32).reshape(8 * 4, 3, 4)
    for s, c in ((0, 0), (0, 1), (0, 2), (2, 0), (2, 1)):
        f = shard_map(lambda v: jax.lax.all_to_all(v, "model", s, c, tiled=False), mesh=mesh,
                      in_specs=P(("data", "model")), out_specs=P(("data", "model")),
                      check_vma=False)
        out[f"a2a/{s}/{c}"] = np.asarray(jax.jit(f)(x))

    ep = np.load(sys.argv[2])
    cfg = get_config("phi3.5-moe-42b-a6.6b", reduced=True)
    act = L.activation_fn(cfg.activation)
    w = [jnp.asarray(ep[k]) for k in ("wi", "wg", "wo")]
    for key in ("disp_b1", "disp_b2"):
        out[f"ep/{key}"] = np.asarray(ep_expert_ffn(jnp.asarray(ep[key]), *w, act, mesh, "data"))

    for arch in ("gemma-2b", "phi3.5-moe-42b-a6.6b"):
        cfg = get_config(arch, reduced=True)
        state = train_loop.init_train_state(cfg, jax.random.PRNGKey(0))
        m, new_dp = ft.elastic_remesh(data_parallel=3, model_parallel=2, lost_ranks=1)
        state2 = ft.reshard_state(state, cfg, m)
        meta[f"{arch}/mesh"] = [list(m.axis_names), [int(m.shape[a]) for a in m.axis_names],
                                new_dp]
        leaves, _ = jax.tree_util.tree_flatten_with_path(state2)
        for path, leaf in leaves:
            key = "/".join(str(p.key) for p in path)
            meta[f"{arch}/spec/{key}"] = [e if e is None or isinstance(e, str) else list(e)
                                          for e in leaf.sharding.spec]
            out[f"{arch}/state/{key}"] = np.asarray(leaf)
    try:
        ft.elastic_remesh(1, 2, lost_ranks=1)
        meta["shrink_below_one"] = "no error"
    except AssertionError:
        meta["shrink_below_one"] = "AssertionError"
    np.savez(sys.argv[1], **out)
    with open(sys.argv[1] + ".json", "w") as fh:
        json.dump(meta, fh)
    print("RESULT:ok")
    """
)


def _moe_dispatch(cfg, B, seed):
    """A prefill dispatch of layer 0 of ``cfg`` (seeded weights, hidden
    states from numpy): ``(disp (B, E, C, d), wi, wg, wo, act)``, fp32."""
    params = registry.init_params(cfg, seed=0, device="cpu")
    p = {k: v[0] for k, v in params["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, EP_S, cfg.d_model)).astype(np.float32))
    _, topi, _ = moe._route(p, x, cfg)
    disp, _, _ = moe._dispatch(x, topi, cfg.num_experts, moe.capacity(cfg, EP_S))
    return disp, p["moe_wi"], p["moe_wg"], p["moe_wo"], L.activation_fn(cfg.activation)


def _tp_einsums(disp, wi, wg, wo, act):
    """``models/moe.py``'s three einsums on ``disp`` (fp32, no TP mesh)."""
    h = torch.einsum("becd,edf->becf", disp, wi)
    g = torch.einsum("becd,edf->becf", disp, wg)
    h = act(g.float()) * h.float()
    return torch.einsum("becf,efd->becd", h.to(disp.dtype), wo)


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    cfg = get_config(MOE, reduced=True)
    disp1, wi, wg, wo, _ = _moe_dispatch(cfg, 2, seed=1)
    disp2 = _moe_dispatch(cfg, 4, seed=2)[0]
    np.savez(d / "ep_in.npz", disp_b1=disp1.numpy(), disp_b2=disp2.numpy(), wi=wi.numpy(),
             wg=wg.numpy(), wo=wo.numpy())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    path = d / "ref.npz"
    proc = subprocess.run([sys.executable, "-c", _REF, str(path), str(d / "ep_in.npz")],
                          capture_output=True, text=True, env=env, timeout=REF_TIMEOUT)
    assert proc.returncode == 0 and "RESULT:ok" in proc.stdout, proc.stderr[-3000:]
    return np.load(path), json.loads(Path(str(path) + ".json").read_text())


# ---------------------------------------------------------------------------
# elastic_remesh / reshard_state
# ---------------------------------------------------------------------------


def test_elastic_remesh_state_survives():
    """The reference's ``test_elastic_remesh_state_survives`` on the port:
    gemma-2b REDUCED, a 1 x 1 mesh, the state bitwise the reference's
    resharded state."""
    cfg = get_config("gemma-2b", reduced=True)
    jstate = jtl.init_train_state(jax_get_config("gemma-2b", reduced=True),
                                  jax.random.PRNGKey(0))
    jmesh, jdp = jft.elastic_remesh(data_parallel=1, model_parallel=1, lost_ranks=0)
    jstate2 = jft.reshard_state(jstate, jax_get_config("gemma-2b", reduced=True), jmesh)
    state = train_loop.state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    mesh, new_dp = ft.elastic_remesh(data_parallel=1, model_parallel=1, lost_ranks=0,
                                     device="cpu")
    assert new_dp == jdp == 1 and mesh.shape == {"data": 1, "model": 1}
    state2 = ft.reshard_state(state, cfg, mesh)
    assert all(isinstance(x, sh.Placed) for x in tree.leaves(state2))
    got = _flat(sh.gather_(state2))
    want = _flat(jax.tree.map(np.asarray, jstate2))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_elastic_remesh_shapes_and_errors(ref_run):
    _, meta = ref_run
    mesh, new_dp = ft.elastic_remesh(3, 2, lost_ranks=1, device="cpu")
    axes, sizes, jdp = meta[f"{MOE}/mesh"]
    assert list(mesh.axis_names) == axes and [mesh.shape[a] for a in axes] == sizes
    assert new_dp == jdp == 2
    assert meta["shrink_below_one"] == "AssertionError"
    with pytest.raises(ValueError, match="below one"):
        ft.elastic_remesh(1, 2, lost_ranks=1, device="cpu")
    mesh, _ = ft.elastic_remesh(3, 2, lost_ranks=1, devices=["cpu"] * 6)
    assert mesh.n == 4 and len(mesh.devices) == 4
    with pytest.raises(ValueError, match="devices"):
        ft.elastic_remesh(3, 2, lost_ranks=0, devices=["cpu"] * 4)


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


@pytest.mark.parametrize("arch", RESHARD_ARCHS)
def test_reshard_state_on_2x2_matches_the_reference(ref_run, arch):
    """The reference's state, resharded by the port onto the 2 x 2 mesh
    that ``elastic_remesh(3, 2, lost_ranks=1)`` gives: each leaf's spec the
    reference's, each part its spec's shard shape in its own allocation,
    the gathered state bitwise, and the input left as it was."""
    ref, meta = ref_run
    cfg = get_config(arch, reduced=True)
    np_state = _nest(ref, f"{arch}/state/")
    state = train_loop.state_from_jax(np_state, device="cpu")
    before = {k: v.clone() for k, v in _flat(state).items()}
    mesh, _ = ft.elastic_remesh(3, 2, lost_ranks=1, device="cpu")
    placed = _flat(ft.reshard_state(state, cfg, mesh))
    assert sorted(placed) == sorted(before)
    for k, x in placed.items():
        assert isinstance(x, sh.Placed), k
        want_spec = [tuple(e) if isinstance(e, list) else e for e in meta[f"{arch}/spec{k}"]]
        got_spec = list(x.sharding.spec)
        got_spec += [None] * (len(want_spec) - len(got_spec))
        want_spec += [None] * (len(got_spec) - len(want_spec))
        assert got_spec == want_spec, k
        shard = x.sharding.shard_shape(x.shape)
        assert all(tuple(p.shape) == shard for p in x.parts), k
        assert len({p.data_ptr() for p in x.parts}) == mesh.n, k
        assert torch.equal(x.gather(), before[k]), k
        assert torch.equal(_flat(state)[k], before[k]), k
    assert any(any(e is not None for e in x.sharding.spec) for x in placed.values())


def test_reshard_from_one_placement_onto_another():
    """A placed state (data 2 x model 2) resharded onto the mesh left after
    one data row is lost (1 x 2): parts of the new mesh's specs, gathered
    bitwise; the old placement still gathers bitwise."""
    cfg = get_config(MOE, reduced=True)
    state = train_loop.init_train_state(cfg, 0, device="cpu")
    want = {k: v.clone() for k, v in _flat(state).items()}
    m22, _ = ft.elastic_remesh(2, 2, device="cpu")
    old = ft.reshard_state(state, cfg, m22)
    m12, new_dp = ft.elastic_remesh(2, 2, lost_ranks=1, device="cpu")
    assert new_dp == 1 and m12.shape == {"data": 1, "model": 2}
    new = _flat(ft.reshard_state(old, cfg, m12))
    for k, x in new.items():
        assert x.sharding.mesh is m12 and len(x.parts) == 2, k
        assert all(tuple(p.shape) == x.sharding.shard_shape(x.shape) for p in x.parts), k
        assert torch.equal(x.gather(), want[k]), k
    for k, x in _flat(old).items():
        assert x.sharding.mesh is m22 and torch.equal(x.gather(), want[k]), k
    specs = train_loop.state_shardings(cfg, state, m12)
    for k, s in _flat(specs).items():
        assert tuple(new[k].sharding.spec) == tuple(s.spec), k


# ---------------------------------------------------------------------------
# all_to_all and ep_expert_ffn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split,concat", A2A_PAIRS)
def test_all_to_all_matches_jax(ref_run, split, concat):
    ref, _ = ref_run
    mesh = DeviceMesh({"data": 2, "model": 4}, device="cpu")
    x = torch.arange(8 * 4 * 3 * 4, dtype=torch.float32).reshape(8 * 4, 3, 4)
    parts = mesh.shard(x, 0)  # rank order: data major, model minor
    got = collectives.all_to_all(parts, mesh, "model", split, concat)
    assert len({p.data_ptr() for p in got}) == mesh.n
    np.testing.assert_array_equal(mesh.gather(got, 0).numpy(), ref[f"a2a/{split}/{concat}"])


def test_all_to_all_checks_the_split_dim():
    mesh = DeviceMesh({"data": 1, "model": 4}, device="cpu")
    with pytest.raises(ValueError, match="not the 4 ranks"):
        collectives.all_to_all([torch.zeros(3, 2)] * 4, mesh, "model", 0, 1)


def test_ep_expert_ffn_matches_the_reference_on_2x4(ref_run):
    """One batch row per data rank: the port's output within 1e-5 of the
    reference's; at two rows per data rank the port's is its TP einsums'
    while the reference's return exchange puts rows elsewhere."""
    ref, _ = ref_run
    cfg = get_config(MOE, reduced=True)
    mesh = DeviceMesh({"data": 2, "model": 4}, device="cpu")
    disp1, wi, wg, wo, act = _moe_dispatch(cfg, 2, seed=1)
    got = collectives.ep_expert_ffn(disp1, wi, wg, wo, act, mesh, "data")
    assert float(disp1.abs().sum()) > 0 and tuple(got.shape) == tuple(disp1.shape)
    np.testing.assert_allclose(got.numpy(), ref["ep/disp_b1"], rtol=1e-5, atol=1e-5)
    disp2 = _moe_dispatch(cfg, 4, seed=2)[0]
    ep_ffn = collectives.ep_expert_ffn(disp2, wi, wg, wo, act, mesh, "data")
    tp = _tp_einsums(disp2, wi, wg, wo, act)
    np.testing.assert_allclose(ep_ffn.numpy(), tp.numpy(), rtol=1e-5, atol=1e-5)
    assert np.abs(ref["ep/disp_b2"] - tp.numpy()).max() > 1e-2 * np.abs(tp.numpy()).max()


@pytest.mark.parametrize("shape", [{"data": 2, "model": 2}, {"data": 1, "model": 4}],
                         ids=["2x2", "1x4"])
@pytest.mark.parametrize("experts", [16, 8])
def test_ep_expert_ffn_matches_the_tp_einsums(shape, experts):
    cfg = get_config(MOE, reduced=True).replace(num_experts=experts)
    mesh = DeviceMesh(shape, device="cpu")
    disp, wi, wg, wo, act = _moe_dispatch(cfg, 4, seed=3)
    want = _tp_einsums(disp, wi, wg, wo, act)
    got = collectives.ep_expert_ffn(disp, wi, wg, wo, act, mesh, "data")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    # expert weights placed once on the mesh, split over model on E
    ns = sh.NamedSharding(mesh, sh.P("model", None, None))
    placed = [sh.Placed.of(w, ns) for w in (wi, wg, wo)]
    again = collectives.ep_expert_ffn(disp, *placed, act, mesh, "data")
    assert torch.equal(again, got)
    # ungated: act(x wi) is not asked for, only x wi then wo
    plain = collectives.ep_expert_ffn(disp, wi, None, wo, act, mesh, "data")
    want = torch.einsum("becf,efd->becd", torch.einsum("becd,edf->becf", disp, wi), wo)
    np.testing.assert_allclose(plain.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)


def test_ep_expert_ffn_refuses_what_does_not_split():
    mesh = DeviceMesh({"data": 1, "model": 4}, device="cpu")
    disp = torch.zeros(2, 6, 2, 8)
    w = torch.zeros(6, 8, 4)
    with pytest.raises(ValueError, match="6 experts"):
        collectives.ep_expert_ffn(disp, w, None, w.transpose(1, 2), torch.relu, mesh, "data")
    disp, w = torch.zeros(2, 8, 2, 8), torch.zeros(8, 8, 4)
    wrong = sh.Placed.of(w, sh.NamedSharding(mesh, sh.P(None, "model", None)))
    with pytest.raises(ValueError, match="placed as"):
        collectives.ep_expert_ffn(disp, wrong, None, w.transpose(1, 2), torch.relu, mesh, "data")
