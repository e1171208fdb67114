"""The LM comm-savings study on the port against the reference, at smoke
scale on the CPU (``benchmarks/torch_comm_savings.py``: the reduced
mamba2-370m, 8 agents, on the reference's weights and batches): the
reference rows' schema, the comm rates and losses at the module's stated
tolerance, the dict-spec store entry, and the weights themselves."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from benchmarks.check_bench import check_suite  # noqa: E402
from benchmarks import comm_savings as j_cs  # noqa: E402
from benchmarks import torch_comm_savings as t_cs  # noqa: E402

from study_parity import run_pair  # noqa: E402


@pytest.fixture(scope="module")
def comm(tmp_path_factory):
    root = tmp_path_factory.mktemp("comm_savings")
    jax_rows, torch_rows = run_pair(j_cs, t_cs, root)
    return dict(root=root, jax=jax_rows, torch=torch_rows)


# ------------------------------------------------------- comm savings ----


def test_comm_savings_rows_pass_the_reference_schema(comm):
    assert check_suite("comm_savings", comm["jax"], comm["torch"]) == []
    assert all(row["device"] == "cpu" for row in comm["torch"])


def test_comm_savings_headlines_match_the_reference_run(comm):
    assert t_cs.fidelity(comm["torch"], True,
                         want=t_cs.headlines(comm["jax"])) == []


def test_comm_savings_recorded_jax_numbers_are_the_reference_run(comm):
    assert t_cs.fidelity(comm["jax"], True) == []
    assert t_cs.fidelity(comm["torch"], True) == []


def test_comm_savings_persists_one_dict_spec_entry(comm):
    from repro_torch.experiments.report import render_entry
    from repro_torch.experiments.store import SweepStore
    store = SweepStore(comm["root"] / "torch" / "store")
    (h,) = store.hashes()
    entry = store.get(h)
    assert entry.extra["figure"] == "comm_savings"
    assert tuple(entry.axes) == ("lam",)
    rows = render_entry(entry)["rows"]
    assert [r["lam"] for r in rows] == [r["lam"] for r in comm["torch"]]
    t_cs._persist(store, [r["lam"] for r in comm["torch"]],
                  t_cs._scale(True)[0], comm["torch"])
    assert store.hashes() == [h]          # an existing entry is kept


def test_reference_weights_are_the_reference_init():
    """The study's weights: every random leaf of the reference's
    ``MambaLM.init(key(0))`` bit for bit, the constants within one ulp."""
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro_torch.configs import get_config
    from repro_torch.convert import state_dict_from_jax, to_numpy
    from repro_torch.models import build_model
    from repro_torch.models.ssm_model import reference_weights
    cfg = jax_config("mamba2-370m").reduced()
    want = state_dict_from_jax(to_numpy(
        jax_build(cfg).init(jax.random.key(0))))
    got = reference_weights(build_model(
        get_config("mamba2-370m").reduced(), "cpu"), seed=0).state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if k.rsplit(".", 1)[-1] in ("embed", "w_in", "conv_w", "w_out"):
            assert torch.equal(v, want[k]), k
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=2.5e-7,
                                   atol=0, err_msg=k)
