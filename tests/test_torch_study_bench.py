"""The engine and kernel suites on the port against the reference's, at
smoke scale on the CPU: ``benchmarks/torch_sweep_step.py`` (the step
backends), ``torch_kernels_bench.py`` (each kernel beside its plain
version) and ``torch_sweep_scaling.py`` (the env-family sweep).

- sweep_step: the port's rows pass ``check_suite`` against the
  reference's smoke rows through exactly one relabel (gain backend
  ``kernel`` -> ``pallas``) and fail it without; every step backend's
  final weights equal the reference step backend's within 1e-5; the
  synthetic sampler draws the reference's numbers; the suite's inner run
  equals the reference's ``gated_sgd_core`` on the same key within 1e-5.
- kernels: the rows have the reference's kinds and fields and pass the
  suite's own gate, which fails a row past its tolerance; each kernel's
  plain version equals the reference's at the smoke shapes.
- env_family: the row passes ``check_suite`` against the reference's
  sweep (run here without the device mesh, which JAX 0.9.0 refuses in
  the reference's own subprocess) and the committed schema, and its
  ``fidelity`` table is the live reference's.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from benchmarks import kernels_bench as j_kernels  # noqa: E402
from benchmarks import sweep_step as j_step  # noqa: E402
from benchmarks import torch_kernels_bench as t_kernels  # noqa: E402
from benchmarks import torch_sweep_scaling as t_scaling  # noqa: E402
from benchmarks import torch_sweep_step as t_step  # noqa: E402
from benchmarks.check_bench import check_suite  # noqa: E402

from study_parity import one_thread  # noqa: E402


@pytest.fixture(scope="module")
def step_rows():
    with one_thread():
        return dict(jax=j_step.run(smoke=True),
                    torch=t_step.run(smoke=True, device="cpu"))


@pytest.fixture(scope="module")
def kernel_rows():
    with one_thread():
        return dict(jax=j_kernels.run(smoke=True),
                    torch=t_kernels.run(smoke=True, device="cpu"))


def _reference_env_family(cfg):
    """sweep_scaling's env_family subprocess body on the reference's
    library, in this process and without the mesh, as its row."""
    from repro.core.algorithm1 import ParamSampler
    from repro.envs import family_sampler_fn, garnet_env_family
    from repro.experiments import SweepSpec, run_sweep
    envs, fam = garnet_env_family(cfg["env_instances"], num_states=20)
    w0 = jnp.zeros(20)
    spec = SweepSpec(
        modes=("theoretical", "practical"), lambdas=(1e-3,),
        seeds=tuple(range(cfg["seeds"])), rhos=(0.999,), eps=0.4,
        num_iterations=cfg["iters"], num_agents=cfg["agents"],
        trace="summary")
    sampler = ParamSampler(fn=family_sampler_fn(10),
                           params=envs[0].agent_params(w0, cfg["agents"]))
    runs = cfg["env_instances"] * int(np.prod(spec.grid_shape))
    t0 = time.perf_counter()
    jax.block_until_ready(run_sweep(spec, sampler, w0,
                                    env_sets=fam).comm_rate)
    t1 = time.perf_counter()
    res = run_sweep(spec, sampler, w0, env_sets=fam)
    jax.block_until_ready(res.comm_rate)
    t2 = time.perf_counter()
    jf = np.asarray(res.j_final, np.float64)
    env_ax = res.axes.index("env_set")
    non_env = tuple(i for i in range(jf.ndim) if i != env_ax)
    return dict(grid_runs=runs, first_call_s=t1 - t0, exec_s=t2 - t1,
                runs_per_s=runs / (t2 - t1),
                us_per_call=(t2 - t1) * 1e6 / runs, bench="sweep_scaling",
                suite="env_family", devices=jax.device_count(),
                env_instances=cfg["env_instances"], jitted_calls=1,
                axes=list(res.axes), J_final_mean=float(jf.mean()),
                J_final_spread=float(np.std(jf.mean(axis=non_env))),
                comm_rate_mean=float(np.mean(np.asarray(res.comm_rate,
                                                        np.float64))))


@pytest.fixture(scope="module")
def family_rows():
    with one_thread():
        return dict(jax=[_reference_env_family(t_scaling._scale(True))],
                    torch=t_scaling.run(smoke=True, device="cpu"))


# ------------------------------------------------------------ sweep_step ---


def test_sweep_step_rows_pass_the_reference_schema_through_one_relabel(
        step_rows):
    jax_rows, torch_rows = step_rows["jax"], step_rows["torch"]
    assert check_suite("sweep_step", jax_rows,
                       t_step.relabel(torch_rows)) == []
    assert t_step.gate(torch_rows) == []
    # without the relabel the kernel backend's rows are missing
    assert any("lost backend rows" in v
               for v in check_suite("sweep_step", jax_rows, torch_rows))
    # the relabel touches the gain backend's kernel value and nothing else
    for row, copy in zip(torch_rows, t_step.relabel(torch_rows)):
        changed = {k for k in row if row[k] != copy[k]}
        assert changed == ({"gain_backend"}
                           if row.get("gain_backend") == "kernel" else set())
    assert all(r["gain_backend"] in t_step.GAIN_BACKENDS for r in torch_rows)
    assert all(r["device"] == "cpu" for r in torch_rows)


def test_sweep_step_backends_end_on_the_reference_step_weights(step_rows):
    errs = [r["final_weights_max_abs_vs_reference"]
            for r in step_rows["torch"]
            if "final_weights_max_abs_vs_reference" in r]
    assert len(errs) == 2 * 3 * 2          # 2 gain backends x 3 x 2 stages
    assert max(errs) <= t_step.WEIGHT_TOL
    # the reference's stated order is reported on the kernel full step
    assert [r["m"] for r in step_rows["torch"]
            if "order_holds" in r] == [8] * 3


def test_sweep_step_sampler_draws_the_reference_numbers():
    from repro_torch import random as trandom
    T, n = 16, 8
    w_true = np.random.default_rng(1).normal(size=(n,)).astype(np.float32)
    keys = jax.random.split(jax.random.key(3), 6)
    want_phi, want_t = j_step._make_sample_all(T, n, jnp.asarray(w_true))(keys)
    tkeys = torch.from_numpy(np.asarray(jax.random.key_data(keys)
                                        ).astype(np.int64))
    got_phi, got_t = t_step.make_sample_all(
        T, n, torch.from_numpy(w_true))(tkeys[None])
    np.testing.assert_array_equal(got_phi[0].numpy(), np.asarray(want_phi))
    np.testing.assert_allclose(got_t[0].numpy(), np.asarray(want_t),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("step_backend", t_step.STEP_BACKENDS)
def test_sweep_step_inner_run_is_the_reference_core(step_backend):
    m, T, n = t_step.SMOKE_STEP_SHAPES[0]
    with one_thread():
        got = t_step._core("cpu", m, T, n, "reference", step_backend, 5)()
    want = jax.jit(j_step._core_runner(m, T, n, "reference", step_backend,
                                       5))(jax.random.key(0))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want.final_weights),
                               rtol=0, atol=t_step.WEIGHT_TOL)


# --------------------------------------------------------------- kernels ---


def test_kernel_rows_have_the_reference_kinds_and_fields(kernel_rows):
    jax_rows, torch_rows = kernel_rows["jax"], kernel_rows["torch"]
    assert check_suite("kernels", jax_rows, torch_rows) == []
    assert [r["bench"] for r in torch_rows] == [r["bench"] for r in jax_rows]
    assert [r["shape"] for r in torch_rows] == [r["shape"] for r in jax_rows]
    for t, j in zip(torch_rows, jax_rows):
        assert t["gflop_per_call"] == pytest.approx(j["gflop_per_call"])
    assert t_kernels.gate(torch_rows) == []
    assert all(r["route"] == "plain" and r["device"] == "cpu"
               for r in torch_rows)


def test_kernel_gate_fails_an_error_past_its_tolerance(kernel_rows):
    rows = [dict(r) for r in kernel_rows["torch"]]
    rows[2]["max_scaled_err"] = 2 * t_kernels.FLASH_TOL
    assert any("kernel_flash" in v for v in t_kernels.gate(rows))
    assert t_kernels.gate(rows[:3])
    rows = [dict(r) for r in kernel_rows["torch"]]
    del rows[0]["route"]
    assert any("lacks" in v for v in t_kernels.gate(rows))


@pytest.mark.parametrize("name", ["gain_matvec", "gain_family_stats",
                                  "flash_attention", "ssd_chunk"])
def test_plain_versions_are_the_reference_at_the_smoke_shapes(name):
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    cfg = t_kernels._scale(True)
    rng = np.random.default_rng(0)

    def draw(*shape):
        return rng.normal(size=shape).astype(np.float32)

    if name == "gain_matvec":
        args = (draw(*cfg["matvec"]), draw(cfg["matvec"][1]))
        want = [jref.gain_matvec_ref(*map(jnp.asarray, args))]
        got = [tref.gain_matvec_ref(*map(torch.from_numpy, args))]
    elif name == "gain_family_stats":
        m, T, n = cfg["family"]
        args = (draw(m, T, n), draw(m, n), draw(n), draw(n, n))
        want = [jref.gain_family_stats_ref(*map(jnp.asarray, args))]
        got = [tref.gain_family_stats_ref(*map(torch.from_numpy, args))]
    elif name == "flash_attention":
        B, L, H, KVH, D = cfg["flash"]
        args = (draw(B, L, H, D), draw(B, L, KVH, D), draw(B, L, KVH, D))
        want = [jref.flash_attention_ref(*map(jnp.asarray, args))]
        got = [tref.flash_attention_ref(*map(torch.from_numpy, args))]
    else:
        Bc, nc, Q, H, P, N = cfg["ssd"]
        dtx = draw(Bc, nc, Q, H, P)
        cum = (-np.abs(draw(Bc, nc, Q, H)).cumsum(2) * 0.1).astype(np.float32)
        bm, cm = draw(Bc, nc, Q, N), draw(Bc, nc, Q, N)
        got = tref.ssd_chunk_ref(*map(torch.from_numpy, (dtx, cum, bm, cm)))
        y, st = jax.vmap(jax.vmap(jax.vmap(
            jref.ssd_chunk_ref, in_axes=(1, 1, None, None),
            out_axes=(1, 0))))(*map(jnp.asarray, (dtx, cum, bm, cm)))
        want = [y, st]
    tol = t_kernels.TOLERANCE[{"gain_matvec": "kernel_gain",
                               "gain_family_stats": "kernel_gain_family",
                               "flash_attention": "kernel_flash",
                               "ssd_chunk": "kernel_ssd"}[name]]
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=tol,
                                   atol=tol * max(1.0, np.abs(w).max()))


# ------------------------------------------------------------ env_family ---


def test_env_family_row_passes_the_reference_schema(family_rows):
    assert check_suite("sweep_scaling", family_rows["jax"],
                       family_rows["torch"]) == []
    assert t_scaling.gate(family_rows["torch"]) == []
    (row,) = family_rows["torch"]
    assert row["devices"] == 1 and row["suite"] == "env_family"
    assert row["axes"] == family_rows["jax"][0]["axes"]
    assert row["grid_runs"] == family_rows["jax"][0]["grid_runs"]


def test_env_family_headlines_match_the_reference_run(family_rows):
    want = t_scaling.headlines(family_rows["jax"])
    ties = []
    assert t_scaling.fidelity(family_rows["torch"], True, want=want,
                              ties=ties) == []
    assert ties == []


def test_env_family_recorded_jax_numbers_are_the_reference_run(family_rows):
    assert t_scaling.fidelity(family_rows["jax"], True) == []
    assert t_scaling.fidelity(family_rows["torch"], True) == []
