"""Wrappers of the CUDA gain kernels (``csrc/gain.cu``), ported from the
Pallas kernels of ``repro/kernels/gain.py``.

Each wrapper takes tensors on one device.  For CPU tensors it returns its
plain-torch version (``repro_torch.kernels.ref``); for CUDA tensors it checks
dtype, shape and contiguity, allocates the outputs, launches the kernel on
the current stream and raises if the launch failed — it never falls back.
``LAUNCHES`` counts kernel launches per wrapper (only where a kernel is
launched; ``megastep`` launches two per call), so a run can show that it
went through the kernels.

Dtypes: phi and g in float32, bf16 or float16, each kernel instantiated
for all three (float16 counted apart, ``LAUNCHES["<wrapper>_f16"]``).
Where phi and g differ in dtype both are cast to float32, exactly, as the
Pallas kernels' ``astype(float32)`` reads them, and the float32 kernels run;
grad_j and Phi are read in float32 the same way (``route`` says which).
``megastep_call`` takes any number of agents.

Unlike the Pallas entries there is no ``custom_vmap`` rule: the wrappers
take the leading batch (run) axis directly, and one call is one launch over
every agent of every run.

``gain_family_stats`` and ``megastep_call`` take the family kernel's
run-time tiling as the Pallas entries take theirs, and ``gain_matvec`` /
``practical_gain`` their T-tile: a per-call ``block_m`` / ``block_t``
beats ``REPRO_TORCH_KERNEL_BLOCKS`` (``name=int,...``; the port's own
variable, so the two packages' tunings never cross), which beats the
default.  The names are the reference's where the meaning is the same:
``block_t`` (rows per T-tile of ``gain_matvec``; default: a tile of about
``MATVEC_TILE_BYTES`` of phi, ``matvec_geometry``), ``block_m`` (agents
per block of ``gain_family_stats``), ``megastep_block_m`` (of
``megastep_call``) and ``family_block_t`` (rows per T-tile, both).  The
reference's ``block_n`` and ``family_block_n`` have no counterpart here (a
row's dot product is never split) and are refused like any unknown name;
the kernels' other launch shapes are compiled in.  No tiling moves a bit
of any output.  The blocks are resolved and checked before the CPU
branch, so the plain path holds the same contract.
"""

from __future__ import annotations

import functools
import operator
import os
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import check as _check
from repro_torch.kernels.common import need as _need
from repro_torch.kernels.common import on_cuda as _on_cuda
from repro_torch.kernels.common import ptr as _ptr
from repro_torch.kernels.common import stream as _stream

# Column order of the (..., m, 4) stats array gain_family_stats emits.
STAT_GNORM2, STAT_SUMPROJ2, STAT_GDOTJ, STAT_QUAD = range(4)


class Route(NamedTuple):
    kernel: str           # the CUDA kernel(s), as a profiler trace names them
    counter: str          # its key in LAUNCHES
    dtype: torch.dtype    # the dtype the kernel reads phi and g in


# each wrapper's kernels ("practical_gain" launches gain_matvec's)
KERNELS = {"gain_matvec": "matvec_gain_kernel",
           "gain_family_stats": "family_stats_kernel",
           "megastep": "family_stats_kernel + gate_update_kernel"}
LAUNCHES = {name + suffix: 0 for suffix in ("", "_f16") for name in KERNELS}

# The family kernel's run-time tiling (csrc/gain.cu family_stats_kernel):
# agents per block and rows per T-tile.  On the H100, 4 agents and 64 rows
# beat 8 or 16 agents and 128 rows at the main path's shape and the kernel
# suite's (PERF.md §6; the Pallas kernel's FAMILY_BLOCK_T is 128).
BLOCK_M = 4
MEGASTEP_BLOCK_M = 4
FAMILY_BLOCK_T = 64
# rows of Phi in one quadratic-form chunk: csrc/gain.cu kQuadRows (compiled
# in; the launcher refuses another chunk count)
QUAD_ROWS = 64

# gain_matvec's default T-tile: rows of about this many bytes of phi, in
# steps of MATVEC_ROW_STEP rows (csrc/gain.cu kRowsInFlight), at least one
# step.  On the H100 128 KiB was within the spread of the fastest block_t
# at each of tools/matvec_block_t.py's shapes (the kernel suite's one
# agent: 256 tiles of 16 rows), 256 KiB slower at 64 x 1024 x 512 float16,
# and it keeps wide-192's agents (128 x 256 float32) at one tile (PERF.md
# section 6).
MATVEC_TILE_BYTES = 128 * 1024
MATVEC_ROW_STEP = 8

BLOCKS_ENV = "REPRO_TORCH_KERNEL_BLOCKS"

# every block parameter _block() can resolve; an env override naming
# anything else is a typo that would otherwise silently do nothing
KNOWN_BLOCKS = ("block_m", "block_t", "family_block_t", "megastep_block_m")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=64)
def route(wrapper: str, phi_dtype: torch.dtype, g_dtype: torch.dtype) -> Route:
    """The kernel, launch counter and dtype of a CUDA call of ``wrapper``
    (a key of ``KERNELS``) on phi and g of these dtypes: theirs when they
    share it, else float32 (both cast, exactly)."""
    for name, dt in (("phi", phi_dtype), ("g", g_dtype)):
        if dt not in _DTYPES:
            raise TypeError(f"{name}: dtype {dt} not in {tuple(_DTYPES)}")
    dt = phi_dtype if phi_dtype == g_dtype else torch.float32
    return Route(KERNELS[wrapper],
                 wrapper + ("_f16" if dt == torch.float16 else ""), dt)


def _cast(r: Route, phi: torch.Tensor, g: torch.Tensor):
    """phi and g in the route's dtype (the same tensors when they are)."""
    if phi.dtype == g.dtype == r.dtype:
        return phi, g
    return phi.to(r.dtype), g.to(r.dtype)


def env_blocks() -> dict[str, int]:
    """Parse ``REPRO_TORCH_KERNEL_BLOCKS`` into a name->int override map
    (the format, checks and messages of ``repro.kernels.gain.env_blocks``)."""
    raw = os.environ.get(BLOCKS_ENV, "")
    out: dict[str, int] = {}
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(
                f"{BLOCKS_ENV} entries must be name=int, got {item!r}")
        name, _, val = item.partition("=")
        name = name.strip()
        if name not in KNOWN_BLOCKS:
            raise ValueError(
                f"{BLOCKS_ENV}: unknown block name {name!r} "
                f"(valid names: {', '.join(KNOWN_BLOCKS)})")
        try:
            out[name] = int(val)
        except ValueError:
            raise ValueError(
                f"{BLOCKS_ENV}: {name}={val.strip()!r} is not an "
                "integer") from None
    return out


def _block(name: str, override: Optional[int], default: int,
           env: Optional[dict] = None) -> int:
    """Per-call override > env override (``env``: ``env_blocks()`` already
    parsed) > module default, checked to be a positive integer."""
    if override is None:
        override = (env_blocks() if env is None else env).get(name, default)
    value = override
    try:
        value = operator.index(value)
    except TypeError:
        raise ValueError(f"{name} must be an integer, got {value!r}") from None
    if value < 1:
        raise ValueError(f"{name} must be at least 1, got {value}")
    return value


class FamilyGeometry(NamedTuple):
    """One launch of the family kernel: agents per block, rows per T-tile,
    T-tiles per agent block and Phi chunks (0 without a model)."""
    block_m: int
    block_t: int
    tiles: int
    chunks: int

    @property
    def width(self) -> int:
        """Floats an agent leaves in the kernel's scratch: a partial sum
        per T-tile and per Phi chunk, ||g||^2 and g . grad J."""
        return self.tiles + self.chunks + 2


def family_geometry(T: int, n: int, with_model: bool, *,
                    megastep: bool = False, block_m: Optional[int] = None,
                    block_t: Optional[int] = None) -> FamilyGeometry:
    """Resolve the family kernel's tiling for rows of T x n: ``block_m``
    (``megastep_block_m`` when ``megastep``) and ``family_block_t``, per
    call, else from the env, else the defaults."""
    if block_m is None and block_t is None:
        return _env_geometry(T, n, with_model, megastep,
                             os.environ.get(BLOCKS_ENV, ""))
    return _geometry(T, n, with_model, megastep, block_m, block_t)


@functools.lru_cache(maxsize=256)
def _env_geometry(T, n, with_model, megastep, raw):
    """``family_geometry`` with no per-call override, once per shape and
    value ``raw`` of the variable (a value that raises is not kept): the
    wrappers resolve one a call."""
    return _geometry(T, n, with_model, megastep, None, None)


def _geometry(T, n, with_model, megastep, block_m, block_t):
    env = env_blocks() if block_m is None or block_t is None else {}
    bm = (_block("megastep_block_m", block_m, MEGASTEP_BLOCK_M, env)
          if megastep else _block("block_m", block_m, BLOCK_M, env))
    bt = _block("family_block_t", block_t, FAMILY_BLOCK_T, env)
    tiles = max(1, -(-T // bt))
    chunks = -(-n // QUAD_ROWS) if with_model else 0
    return FamilyGeometry(bm, bt, tiles, chunks)


def _family_scratch(phi, agents, m, geo):
    """The family kernel's scratch for one call: ``geo.width`` partial sums
    an agent, then one 4-byte arrival counter per agent block, which the
    launcher zeroes on the call's stream (csrc/gain.cu launch_family).
    With one T-tile the kernel writes its sums straight out and needs
    none."""
    if geo.tiles == 1:
        return None
    groups = agents // m * -(-m // geo.block_m)
    return torch.empty(agents * geo.width + groups, dtype=torch.float32,
                       device=phi.device)


def _terms(grad_j, phi_matrix, batch, n):
    """Validate per-run or shared model terms (any dtype the kernels
    take; the wrappers read them in float32); returns their strides per
    run (0 for a term every run shares)."""
    batch = tuple(batch)
    dts = tuple(_DTYPES)
    if grad_j.dim() == 1:
        _need(grad_j, "grad_j", (n,), dts)
    else:
        _need(grad_j, "grad_j", batch + (n,), dts)
    if phi_matrix.dim() == 2:
        _need(phi_matrix, "phi_matrix", (n, n), dts)
    else:
        _need(phi_matrix, "phi_matrix", batch + (n, n), dts)
    return (0 if grad_j.dim() == 1 else n,
            0 if phi_matrix.dim() == 2 else n * n)


# ---------------------------------------------------------------------------
# gain_matvec / practical_gain  (Pallas: gain.py::gain_matvec, practical_gain)
# ---------------------------------------------------------------------------


def matvec_vector_pass(n: int, dtype: torch.dtype, *addresses: int) -> bool:
    """Whether the gain kernels launch their vector pass for rows of ``n``
    elements of ``dtype`` at these data addresses (else ``gain_matvec`` /
    ``practical_gain`` take the generic pass and the family kernel its
    lane-group pass): it needs whole 16-byte vectors in every row (n a
    multiple of 4 float32 or 8 bf16) and 16-byte-aligned phi and g."""
    return (n > 0 and n % (16 // dtype.itemsize) == 0
            and all(a % 16 == 0 for a in addresses))


class MatvecGeometry(NamedTuple):
    """One launch of gain_matvec's kernel: rows per T-tile and T-tiles per
    agent."""
    block_t: int
    tiles: int


def matvec_default_block_t(n: int, dtype: torch.dtype) -> int:
    """Rows of about ``MATVEC_TILE_BYTES`` of phi at row width ``n`` in
    ``dtype``, in whole steps of ``MATVEC_ROW_STEP`` rows."""
    rows = MATVEC_TILE_BYTES // max(n * dtype.itemsize, 1)
    return max(MATVEC_ROW_STEP, rows // MATVEC_ROW_STEP * MATVEC_ROW_STEP)


def matvec_geometry(T: int, n: int, dtype: torch.dtype,
                    block_t: Optional[int] = None) -> MatvecGeometry:
    """gain_matvec's tiling of rows of T x n in ``dtype`` (the dtype its
    kernel reads phi in): ``block_t`` per call, else from the env, else
    ``matvec_default_block_t``.  The outputs' bits do not depend on it."""
    if block_t is None:
        return _env_matvec_geometry(T, n, dtype,
                                    os.environ.get(BLOCKS_ENV, ""))
    return _matvec_geometry(T, n, dtype, block_t)


@functools.lru_cache(maxsize=256)
def _env_matvec_geometry(T, n, dtype, raw):
    """``matvec_geometry`` with no per-call override, once per shape and
    value ``raw`` of the variable (a value that raises is not kept)."""
    return _matvec_geometry(T, n, dtype, None)


def _matvec_geometry(T, n, dtype, block_t):
    bt = _block("block_t", block_t, matvec_default_block_t(n, dtype))
    return MatvecGeometry(bt, max(1, -(-T // bt)))


def _matvec_dtype(phi: torch.Tensor, g: torch.Tensor) -> torch.dtype:
    """The dtype gain_matvec's kernel reads phi and g in (``route``'s)."""
    return phi.dtype if phi.dtype == g.dtype else torch.float32


def _matvec_launch(phi, g, eps, want_proj, geo):
    *batch, T, n = phi.shape
    r = route("gain_matvec", phi.dtype, g.dtype)
    _need(phi, "phi", phi.shape, tuple(_DTYPES))
    _need(g, "g", tuple(batch) + (n,), tuple(_DTYPES))
    phi, g = _cast(r, phi, g)
    agents = phi.numel() // max(T * n, 1)
    # the kernel writes only the output asked for
    proj = gain = scratch = None
    if want_proj:
        proj = phi.new_empty(tuple(batch) + (T,), dtype=torch.float32)
    else:
        gain = phi.new_empty(tuple(batch), dtype=torch.float32)
        if geo.tiles > 1:
            # the agents' projections, then a 4-byte arrival counter an
            # agent, zeroed by the launcher (csrc/gain.cu launch_matvec)
            scratch = phi.new_empty((agents * (T + 1),), dtype=torch.float32)
    if agents:
        LAUNCHES[r.counter] += 1
        vec = matvec_vector_pass(n, phi.dtype, phi.data_ptr(), g.data_ptr())
        _check(_build.load().gain_matvec_tiles_launch(
            _ptr(phi), _ptr(g), _DTYPES[phi.dtype], agents, T, n, float(eps),
            int(vec), geo.block_t, geo.tiles, _ptr(proj), _ptr(gain),
            _ptr(scratch), _stream(phi)), "gain_matvec")
    return proj, gain


def gain_matvec(phi: torch.Tensor, g: torch.Tensor, *,
                block_t: Optional[int] = None) -> torch.Tensor:
    """proj = phi @ g per leading index: phi (..., T, n), g (..., n) -> (..., T).
    ``block_t``: rows per T-tile of this launch (module docstring)."""
    geo = matvec_geometry(phi.shape[-2], phi.shape[-1],
                          _matvec_dtype(phi, g), block_t)
    if not _on_cuda(phi, g):
        return ref.gain_matvec_ref(phi, g)
    return _matvec_launch(phi, g, 1.0, True, geo)[0]


def practical_gain(phi: torch.Tensor, g: torch.Tensor, eps: float = 1.0, *,
                   block_t: Optional[int] = None) -> torch.Tensor:
    """Eq. 15 per leading index: -eps ||g||^2 + eps^2 (1/T) sum_t (phi_t.g)^2.
    ``block_t``: rows per T-tile of this launch (module docstring)."""
    geo = matvec_geometry(phi.shape[-2], phi.shape[-1],
                          _matvec_dtype(phi, g), block_t)
    if not _on_cuda(phi, g):
        return ref.practical_gain_ref(phi, g, eps)
    return _matvec_launch(phi, g, eps, False, geo)[1]


# ---------------------------------------------------------------------------
# gain_family_stats  (Pallas: gain.py::gain_family_stats)
# ---------------------------------------------------------------------------


def gain_family_stats(phi: torch.Tensor, g: torch.Tensor,
                      grad_j: Optional[torch.Tensor] = None,
                      phi_matrix: Optional[torch.Tensor] = None, *,
                      block_m: Optional[int] = None,
                      block_t: Optional[int] = None) -> torch.Tensor:
    """Per-agent gain-family statistics in one pass.

    phi (*B, m, T, n) and g (*B, m, n), float32, bf16 or float16 (of
    different dtypes: both read in float32); grad_j (n,) or (*B, n) and
    phi_matrix (n, n) or (*B, n, n), read in float32.  Returns
    (*B, m, 4) ``[||g||^2, sum_t (phi_t.g)^2, g.grad_J, g^T Phi g]`` with a
    model, else the (*B, m, 2) prefix from a variant that never reads Phi.
    ``block_m`` / ``block_t``: agents per block and rows per T-tile of this
    launch (module docstring).
    """
    with_model = grad_j is not None and phi_matrix is not None
    geo = family_geometry(phi.shape[-2], phi.shape[-1], with_model,
                          block_m=block_m, block_t=block_t)
    if not _on_cuda(phi, g, grad_j if with_model else None,
                    phi_matrix if with_model else None):
        return ref.gain_family_stats_ref(phi, g, grad_j if with_model else None,
                                         phi_matrix if with_model else None)
    *batch, m, T, n = phi.shape
    r = route("gain_family_stats", phi.dtype, g.dtype)
    _need(phi, "phi", phi.shape, tuple(_DTYPES))
    _need(g, "g", tuple(batch) + (m, n), tuple(_DTYPES))
    phi, g = _cast(r, phi, g)
    cols = 4 if with_model else 2
    gj, pm = (grad_j, phi_matrix) if with_model else (None, None)
    gj_stride, pm_stride = (_terms(gj, pm, batch, n) if with_model
                            else (0, 0))
    if with_model:
        gj, pm = gj.float(), pm.float()
    out = torch.empty(tuple(batch) + (m, cols), dtype=torch.float32,
                      device=phi.device)
    agents = out.numel() // cols
    if agents:
        part = _family_scratch(phi, agents, m, geo)
        vec = matvec_vector_pass(n, phi.dtype, phi.data_ptr(), g.data_ptr())
        LAUNCHES[r.counter] += 1
        _check(_build.load().gain_family_stats_launch(
            _ptr(phi), _ptr(g), _DTYPES[phi.dtype], int(vec), _ptr(gj),
            gj_stride, _ptr(pm), pm_stride, agents, m, T, n, cols,
            geo.block_m, geo.block_t, geo.tiles, geo.chunks, _ptr(part),
            _ptr(out), _stream(phi)), "gain_family_stats")
    return out


# ---------------------------------------------------------------------------
# megastep  (Pallas: gain.py::megastep_call / megastep)
# ---------------------------------------------------------------------------


def megastep_call(phi: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                  ctl: torch.Tensor, alpha_rand: torch.Tensor,
                  grad_j: Optional[torch.Tensor] = None,
                  phi_matrix: Optional[torch.Tensor] = None,
                  deliver: Optional[torch.Tensor] = None, *,
                  eps: float, block_m: Optional[int] = None,
                  block_t: Optional[int] = None):
    """One whole gated-SGD inner step for R runs.

    Args (leading axis R = runs):
      phi:        (R, m, T, n) float32, bf16 or float16 feature batches.
      g:          (R, m, n) stochastic gradients (phi's dtype, or any of
                  the three: both are then read in float32).
      w:          (R, n) float32 server weights.
      ctl:        (R, 2) float32 ``[threshold, mode_id]``.
      alpha_rand: (R, m) float32 pre-drawn bernoulli decisions.
      grad_j:     (R, n) exact grad J(w), or None.
      phi_matrix: (n, n) shared or (R, n, n) per-run Phi, or None.
      deliver:    optional (R, m) 0/1 channel keep mask: the update
                  aggregates ``alphas * deliver``; alphas stay the attempts.
      block_m, block_t: agents per block and rows per T-tile of the
                  statistics launch (module docstring; the env name of
                  block_m is ``megastep_block_m``).

    Returns ``(w_next (R, n), alphas (R, m), gains (R, m))``.
    """
    with_model = grad_j is not None and phi_matrix is not None
    geo = family_geometry(phi.shape[-2], phi.shape[-1], with_model,
                          megastep=True, block_m=block_m, block_t=block_t)
    if not _on_cuda(phi, g, w, ctl, alpha_rand, deliver,
                    grad_j if with_model else None,
                    phi_matrix if with_model else None):
        return ref.megastep_ref(phi, g, w, ctl, alpha_rand,
                                grad_j if with_model else None,
                                phi_matrix if with_model else None,
                                deliver, eps=eps)
    if phi.dim() != 4:
        raise ValueError(f"phi must be (R, m, T, n), got {tuple(phi.shape)}")
    R, m, T, n = phi.shape
    r = route("megastep", phi.dtype, g.dtype)
    _need(phi, "phi", phi.shape, tuple(_DTYPES))
    _need(g, "g", (R, m, n), tuple(_DTYPES))
    phi, g = _cast(r, phi, g)
    _need(w, "w", (R, n))
    _need(ctl, "ctl", (R, 2))
    _need(alpha_rand, "alpha_rand", (R, m))
    if deliver is not None:
        _need(deliver, "deliver", (R, m))
    cols = 4 if with_model else 2
    gj, pm = (grad_j, phi_matrix) if with_model else (None, None)
    gj_stride = pm_stride = 0
    if with_model:
        if grad_j.dim() != 2:
            raise ValueError("megastep takes a per-run grad_j (R, n)")
        gj_stride, pm_stride = _terms(gj, pm, (R,), n)
        gj, pm = gj.float(), pm.float()
    dev = phi.device
    stats = torch.empty((R, m, cols), dtype=torch.float32, device=dev)
    w_next = torch.empty((R, n), dtype=torch.float32, device=dev)
    alphas = torch.empty((R, m), dtype=torch.float32, device=dev)
    gains = torch.empty((R, m), dtype=torch.float32, device=dev)
    if R * m:
        part = _family_scratch(phi, R * m, m, geo)
        vec = matvec_vector_pass(n, phi.dtype, phi.data_ptr(), g.data_ptr())
        # one C entry, two kernels: family statistics, then gate and update
        LAUNCHES[r.counter] += 2
        _check(_build.load().megastep_launch(
            _ptr(phi), _ptr(g), _DTYPES[phi.dtype], int(vec), _ptr(w),
            _ptr(ctl), _ptr(alpha_rand), _ptr(deliver), _ptr(gj), gj_stride,
            _ptr(pm), pm_stride, R, m, T, n, cols, geo.block_m, geo.block_t,
            geo.tiles, geo.chunks, _ptr(part), float(eps), _ptr(stats),
            _ptr(w_next), _ptr(alphas), _ptr(gains), _stream(phi)),
            "megastep")
    return w_next, alphas, gains


def megastep(phi: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
             ctl: torch.Tensor, alpha_rand: torch.Tensor,
             grad_j: Optional[torch.Tensor] = None,
             phi_matrix: Optional[torch.Tensor] = None,
             deliver: Optional[torch.Tensor] = None, *, eps: float,
             block_m: Optional[int] = None, block_t: Optional[int] = None):
    """Per-run (no leading R axis) whole step: ``megastep_call`` at R = 1."""
    one = lambda x: None if x is None else x.unsqueeze(0)
    out = megastep_call(one(phi), one(g), one(w), one(ctl), one(alpha_rand),
                        one(grad_j), phi_matrix, one(deliver), eps=eps,
                        block_m=block_m, block_t=block_t)
    return tuple(x[0] for x in out)
