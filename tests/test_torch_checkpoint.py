"""repro_torch.checkpoint.store against repro.checkpoint.store.

Both packages write the same npz layout: one member per leaf keyed by its
escaped tree path, NamedTuple field names as key parts, bf16 as uint16
bits, and the ``__dtypes__`` / ``__meta__`` / ``__checksums__`` sidecars.
A file written by either restores in the other; restores are strict about
keys, dtypes and shapes; corrupt bytes raise ``CorruptCheckpointError``;
a write is atomic.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import faults as jfaults  # noqa: E402
from repro.checkpoint import store as jckpt  # noqa: E402
from repro.core.algorithm1 import SummaryTrace as JSummary  # noqa: E402

from repro_torch import faults as tfaults  # noqa: E402
from repro_torch.checkpoint import store as tckpt  # noqa: E402
from repro_torch.core.algorithm1 import SummaryTrace as TSummary  # noqa: E402


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        w=rng.normal(size=(3, 5)).astype(np.float32),
        c=rng.normal(size=(3,)).astype(np.float32),
        n=rng.integers(0, 9, size=(3, 2)).astype(np.int32),
        b=rng.normal(size=(4, 4)).astype(np.float32),
        s=np.float32(rng.normal()),
    )


def _summary(mod_cls, a, conv):
    return mod_cls(final_weights=conv(a["w"]), comm_rate=conv(a["c"]),
                   tx_counts=conv(a["w"][:, :2]), gain_mean=conv(a["w"][:, 1:3]),
                   gain_min=conv(a["w"][:, 2:4]), gain_max=conv(a["w"][:, 3:5]),
                   j_final=None, j_trajectory=None, alphas=None, gains=None,
                   delivered_counts=conv(a["w"][:, :2] * 0.5),
                   delivered_rate=conv(a["c"] * 0.5))


def _jax_tree(a):
    return {"trace": _summary(JSummary, a, jnp.asarray),
            "a/b": [jnp.asarray(a["n"]), jnp.asarray(a["s"])],
            "50%": jnp.asarray(a["b"]).astype(jnp.bfloat16),
            "empty": None}


def _torch_tree(a):
    return {"trace": _summary(TSummary, a, torch.from_numpy),
            "a/b": [torch.from_numpy(a["n"]), torch.tensor(a["s"])],
            "50%": torch.from_numpy(a["b"]).to(torch.bfloat16),
            "empty": None}


def _sidecars(path):
    with np.load(path) as z:
        return ({k: json.loads(str(z[k])) for k in
                 ("__dtypes__", "__meta__", "__checksums__")},
                sorted(z.files))


def _assert_same(got, want):
    """A port tree against a reference tree, leaf by leaf, bitwise."""
    got = dict(got)
    assert got["empty"] is None
    tg, tw = got["trace"], want["trace"]
    assert type(tg).__name__ == type(tw).__name__
    for a, b in zip(tg, tw):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got["a/b"], want["a/b"]):
        assert a.dtype == torch.int32 or a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got["50%"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["50%"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(want["50%"]).view(np.uint16))


def test_same_file_layout_as_the_reference(tmp_path):
    a = _arrays()
    jckpt.save(str(tmp_path / "j.npz"), _jax_tree(a), metadata={"k": 1})
    tckpt.save(str(tmp_path / "t.npz"), _torch_tree(a), metadata={"k": 1})
    assert _sidecars(tmp_path / "t.npz") == _sidecars(tmp_path / "j.npz")
    _, files = _sidecars(tmp_path / "t.npz")
    assert "a%2Fb/0" in files and "50%25" in files
    assert "trace/delivered_rate" in files and "trace/j_final" not in files


def test_reference_file_restores_in_the_port(tmp_path):
    a = _arrays(1)
    path = str(tmp_path / "j.npz")
    jckpt.save(path, _jax_tree(a), metadata={"segment": [0, 3]})
    like = _torch_tree(_arrays(2))
    got, meta = tckpt.restore(path, like)
    assert meta == {"segment": [0, 3]} == tckpt.load_metadata(path)
    _assert_same(got, _jax_tree(a))


def test_port_file_restores_in_the_reference(tmp_path):
    a = _arrays(3)
    path = str(tmp_path / "t.npz")
    tckpt.save(path, _torch_tree(a), metadata={"x": "y"})
    got, meta = jckpt.restore(path, _jax_tree(_arrays(4)))
    assert meta == {"x": "y"}
    _assert_same(_torch_tree(a), got)


def test_restore_takes_numpy_leaves_and_gives_tensors(tmp_path):
    path = str(tmp_path / "t.npz")
    tckpt.save(path, {"x": torch.arange(6.0).reshape(2, 3),
                      "y": np.arange(3, dtype=np.int64)})
    got, _ = tckpt.restore(path, {"x": torch.zeros(2, 3),
                                  "y": torch.zeros(3, dtype=torch.int64)})
    assert got["x"].device.type == "cpu" and got["y"].dtype == torch.int64
    np.testing.assert_array_equal(got["y"].numpy(), np.arange(3))


@pytest.mark.parametrize("case,match", [
    ("missing", "missing from checkpoint"),
    ("extra", "unexpected in checkpoint"),
    ("dtype", "dtype mismatch"),
    ("shape", "shape mismatch"),
])
def test_restore_is_strict(tmp_path, case, match):
    path = str(tmp_path / "t.npz")
    tckpt.save(path, {"x": torch.zeros(2, 3), "y": torch.ones(4)})
    like = {"missing": {"x": torch.zeros(2, 3), "y": torch.ones(4),
                        "z": torch.ones(1)},
            "extra": {"x": torch.zeros(2, 3)},
            "dtype": {"x": torch.zeros(2, 3), "y": torch.ones(4).double()},
            "shape": {"x": torch.zeros(3, 2), "y": torch.ones(4)}}[case]
    with pytest.raises(ValueError, match=match) as err:
        tckpt.restore(path, like)
    assert not isinstance(err.value, tckpt.CorruptCheckpointError)


def test_flatten_refuses_unordered_and_reserved_keys(tmp_path):
    """Keys that do not sort have no pytree order (JAX refuses them too);
    a leaf may not take a sidecar's name."""
    with pytest.raises(ValueError, match="do not sort"):
        tckpt.save(str(tmp_path / "a.npz"), {1: torch.ones(1),
                                             "1": torch.ones(1)})
    with pytest.raises(ValueError, match="reserved"):
        tckpt.save(str(tmp_path / "b.npz"), {"__meta__": torch.ones(1)})


@pytest.mark.parametrize("damage", ["torn", "flip", "garbage"])
def test_corrupt_file_raises(tmp_path, damage):
    path = str(tmp_path / "t.npz")
    tree = {"x": torch.arange(4096.0), "y": torch.ones(3, 3)}
    tckpt.save(path, tree)
    if damage == "torn":
        jfaults.truncate_half(path)
    elif damage == "flip":
        jfaults.flip_bit(path)
    else:
        with open(path, "wb") as f:
            f.write(b"not an npz")
    with pytest.raises(tckpt.CorruptCheckpointError):
        tckpt.restore(path, tree)


def test_checksum_catches_a_decodable_change(tmp_path):
    """Wrong bytes in a well-formed npz fail the sha256 sidecar."""
    path = str(tmp_path / "t.npz")
    tckpt.save(path, {"x": torch.arange(8.0)})
    with np.load(path) as z:
        members = {k: z[k] for k in z.files}
    members["x"] = members["x"] + 1
    np.savez(path, **members)
    with pytest.raises(tckpt.CorruptCheckpointError, match="checksum"):
        tckpt.restore(path, {"x": torch.zeros(8)})


def test_write_is_atomic(tmp_path, monkeypatch):
    """A write that fails part-way leaves the old checkpoint whole and no
    temp file behind."""
    path = str(tmp_path / "t.npz")
    tckpt.save(path, {"x": torch.arange(5.0)}, metadata={"v": 1})

    def torn_savez(f, **kw):
        f.write(b"PK\x03\x04 half a zip")
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.np, "savez", torn_savez)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save(path, {"x": torch.zeros(5)}, metadata={"v": 2})
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["t.npz"]
    got, meta = tckpt.restore(path, {"x": torch.zeros(5)})
    assert meta == {"v": 1}
    np.testing.assert_array_equal(got["x"].numpy(), np.arange(5.0))
    tckpt.save(path, {"x": torch.zeros(5)}, durable=True)
    assert os.listdir(tmp_path) == ["t.npz"]


def test_quarantine_matches_the_reference(tmp_path):
    for mod in (tfaults, jfaults):
        d = tmp_path / mod.__name__
        d.mkdir()
        names = []
        for _ in range(3):
            (d / "c.npz").write_bytes(b"x")
            names.append(os.path.basename(mod.quarantine_path(
                str(d / "c.npz"), "test")))
        assert names == ["c.npz.quarantined-0", "c.npz.quarantined-1",
                         "c.npz.quarantined-2"]
        assert sorted(os.listdir(d)) == names
