"""The port's harness twin (``repro_torch.launch.bench_run``), its last two
bench rows (``launch/bench_rows.py`` ``gemm_rows`` and ``gcn_rows``), the
quickstart (``launch/quickstart.py``) and ``shape_climb
--autotune-record`` against the reference on the CPU.

- ``benchmarks/bench_gemm.py`` and ``bench_gcn.py``: the rows' names equal
  the reference's, the Fig. 10 ``rel_err`` values agree to 1e-6 and the GCN
  outputs to 1e-4 (the reference's weights carried across).
- ``bench_run.main(["--device", "cpu", "--autotune-only", ...])`` prints one
  ``autotune_<op>`` row per entry of the reference's ``DEFAULT_SUITE``,
  ``--json`` writes them, and a second run loads the record it saved.
- ``shape_climb --autotune-record`` counts under the record's blocks,
  attaches its deltas, restores the tables, and refuses a foreign record.
- The quickstart's act 4 losses equal the reference's ``run_training``
  losses at 1e-4 from the reference's initial state.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core import precision as jprecision  # noqa: E402
from repro.core import sparse as jsp  # noqa: E402
from repro.launch import autotune as at  # noqa: E402
from repro.models import gcn as jgcn  # noqa: E402
from repro.runtime import train_loop as jtrain_loop  # noqa: E402
from repro_torch.hopper import dispatch  # noqa: E402
from repro_torch.launch import bench_rows, bench_run, block_search, quickstart, shape_climb  # noqa: E402
from repro_torch.models import gcn  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    dispatch.clear_block_overrides()
    dispatch.clear_plan_overrides()


def _ref_rows(module):
    from benchmarks import common

    n = len(common.ROWS)
    module.run()
    return [r[0] for r in common.ROWS[n:]]


def test_gemm_rows_twin_of_bench_gemm(capsys):
    from benchmarks import bench_gemm

    want = _ref_rows(bench_gemm)
    rows = bench_rows.Rows("cpu")
    errs = bench_rows.gemm_rows(rows, device="cpu")
    assert [r[0] for r in rows.rows] == want
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((512, 512)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((512, 512)), jnp.float32)
    exact = np.asarray(a @ b)
    for pol, rel in errs.items():
        out = np.asarray(jprecision.expanding_gemm(a, b, pol, impl="ref"), np.float32)
        ref_rel = float(np.linalg.norm(out - exact) / np.linalg.norm(exact))
        assert abs(rel - ref_rel) <= 1e-6, pol
    assert {r["name"]: r["rel_err"] for r in rows.json_rows if "rel_err" in r} == \
        {f"fig10_gemm_{p}": errs[p] for p in errs}


def test_gcn_rows_twin_of_bench_gcn(capsys):
    from benchmarks import bench_gcn

    want = _ref_rows(bench_gcn)
    jparams = jgcn.init_params(jax.random.PRNGKey(0), [bench_gcn.F, bench_gcn.F])
    params = gcn.params_from_jax([np.asarray(w) for w in jparams], device="cpu")
    rows = bench_rows.Rows("cpu")
    outs = bench_rows.gcn_rows(rows, device="cpu", params=params)
    assert [r[0] for r in rows.rows] == want
    rng = np.random.default_rng(0)  # the bench's own draws
    for name, n, deg in bench_gcn.GRAPHS:
        L = max(int(round(deg)) + 1, 2)
        cols = rng.integers(0, n, (n, L)).astype(np.int32)
        cols[:, 0] = np.arange(n)
        adj = jsp.EllMatrix(jnp.full((n, L), 1.0 / L, jnp.float32), jnp.asarray(cols), (n, n))
        feats = jnp.asarray(rng.standard_normal((n, bench_gcn.F)), jnp.float32)
        ref = np.asarray(jgcn.forward(jparams, adj, feats))
        np.testing.assert_allclose(outs[name].numpy(), ref, rtol=1e-4, atol=1e-4, err_msg=name)


def test_bench_run_autotune_only(tmp_path, capsys):
    rec, js = str(tmp_path / "rec.json"), str(tmp_path / "rows.json")
    argv = ["--device", "cpu", "--autotune-only", "--autotune-reps", "1",
            "--autotune-budget", "1", "--autotune-record", rec, "--json", js]
    bench_run.main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("autotune_")]
    want = {f"autotune_{op}" for op in at.DEFAULT_SUITE}
    assert {ln.split(",")[0] for ln in lines} == want and len(lines) == len(want)
    assert all(ln.endswith(";searched") for ln in lines)
    payload = json.loads(open(js).read())
    assert payload["backend"] == "cpu" and {r["name"] for r in payload["rows"]} == want
    assert dispatch._plan_overrides == {}  # the harness's overrides ended with it
    bench_run.main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("autotune_")]
    assert len(lines) == len(want) and all(ln.endswith(";loaded") for ln in lines)


def test_shape_climb_applies_a_record_and_refuses_a_foreign_one(tmp_path, capsys):
    record = block_search.autotune(["flash_attention"], time_candidate=lambda c, b: 1.0,
                                   device="cpu")
    (entry,) = record["entries"].values()
    entry["blocks"] = dict(entry["blocks"], bk=512, bq=512)  # a winner that moves the count
    path = str(tmp_path / "rec.json")
    block_search.save_record(record, path)
    shape_climb.main(["--arch", "occamy-gptj", "--shape", "prefill_32k",
                      "--autotune-record", path])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["autotune"] == block_search.record_deltas(record)
    assert dispatch.block_defaults("flash_attention") == \
        dispatch.block_defaults("flash_attention", overrides=False)
    plain = shape_climb.climb("occamy-gptj", "prefill_32k", {})
    assert res["flops_per_device"] != plain["flops_per_device"]  # counted at bk = bq = 512
    record["backend"] = "NVIDIA H100 80GB HBM3 (132 SMs)"
    block_search.save_record(record, path)
    with pytest.raises(ValueError, match="re-run the autotuner"):
        shape_climb.main(["--arch", "occamy-gptj", "--shape", "prefill_32k",
                          "--autotune-record", path])


def test_quickstart_acts_and_losses_match_reference(capsys):
    jcfg = jax_get_config("occamy-gptj", reduced=True)
    _, jlosses, _ = jtrain_loop.run_training(jcfg, JSHAPES["train_4k"], num_steps=10,
                                             batch_override=4, seq_override=64, log_every=5)
    np_init = jax.tree.map(np.asarray,
                           jtrain_loop.init_train_state(jcfg, jax.random.PRNGKey(0)))
    losses = quickstart.act4_train(
        torch.device("cpu"), initial_state=train_loop.state_from_jax(np_init, device="cpu"))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
    device = torch.device("cpu")
    assert quickstart.act1_gemm(device) <= 1e-4
    assert quickstart.act2_sparse(device) <= 1e-5
    rels = quickstart.act3_precision(device)
    assert rels["fp32"] <= 1e-6 and rels["bf16"] <= 1e-2 and rels["fp8"] <= 0.1
