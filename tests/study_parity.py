"""Shared plumbing of the study parity tests (``tests/test_torch_study_*``):
each reference study in ``benchmarks/`` and its port
(``benchmarks/torch_*.py``) run once at ``run(smoke=True)`` on the CPU,
the port with ``device="cpu"``, and the tests hold the port's rows to the
reference's: the committed schema (``check_suite`` on the two runs' rows,
no committed file read), the headline numbers at the port module's
stated tolerance, the module's recorded JAX 0.9.0 table against the live
reference, and a warm second port run that computes nothing."""

import contextlib

import torch


@contextlib.contextmanager
def one_thread():
    """One intra-op thread while a study loops over tiny steps: a small
    op that opens torch's thread pool costs ~100x more when test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def store_of(root, side):
    """The store of ``side`` ("jax" or "torch") under ``root``: each side
    renders its report beside its own store."""
    return root / side / "store"


def run_pair(ref, port, root, takes_store=True, **port_kw):
    """The reference's and the port's smoke rows, each into its own store
    under ``root`` where the study takes one."""
    with one_thread():
        if takes_store:
            jax_rows = ref.run(smoke=True, store=str(store_of(root, "jax")))
            torch_rows = port.run(smoke=True,
                                  store=str(store_of(root, "torch")),
                                  device="cpu", **port_kw)
        else:
            jax_rows = ref.run(smoke=True)
            torch_rows = port.run(smoke=True, device="cpu", **port_kw)
    return jax_rows, torch_rows


class ExecSpy:
    """Counts the sweep engine's block executions (every sweep the port
    computes runs through ``sweep._exec_block``)."""

    def __init__(self, monkeypatch):
        from repro_torch.experiments import sweep
        self.calls = 0
        real = sweep._exec_block

        def spy(*a, **kw):
            self.calls += 1
            return real(*a, **kw)

        monkeypatch.setattr(sweep, "_exec_block", spy)
