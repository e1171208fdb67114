"""Wrappers of the CUDA SSD kernels (``csrc/ssd_scan.cu``), ported from
the Pallas kernel of ``repro/kernels/ssd_scan.py`` and the XLA code around
it in ``ssd_chunked_pallas``.

``ssd_chunk_tiles`` computes, for every (batch, chunk, head), the
intra-chunk output and the chunk's state (the kernels' notes have the
formulas); ``ssd_state_pass`` carries the state across the chunks and adds
the inter-chunk output term.  For CPU tensors each returns its plain version
(``ref.ssd_chunk_ref``, ``ref.ssd_state_pass_ref``); for CUDA tensors it
checks them, launches a kernel on the current stream and raises if the
launch failed — it never falls back.  The kernels are forward-only: a CUDA
input that requires grad raises.

Routing of the tile (``route``), by shape, the dtype of B and C and
alignment:

- Q in {64, 128}, N and P in {64, 128}, float32 or bf16 B/C, every input
  on a 16-byte boundary -> ``ssd_chunk_wgmma_kernel``: every product on
  the tensor cores (wgmma), each float32 operand as three bf16 pieces in
  six products, float32 accumulation.  Counted in
  ``LAUNCHES["ssd_chunk_tiles_wgmma"]``.  Float32 B/C at Q = N = P = 128
  is the exception: its pieces do not fit a block's shared memory.
- Q in {64, 128}, N 16 (jamba's state width), P in {64, 128}, float32 or
  bf16 B/C, aligned -> ``ssd_chunk_wgmma_n16_kernel``: the same tile and
  arithmetic with B and C in one swizzle atom and G made for each head,
  two blocks an SM.  Counted in ``LAUNCHES["ssd_chunk_tiles_wgmma_n16"]``.
- every other shape up to ``MAX_DIM`` with float32 or bf16 B/C ->
  ``ssd_chunk_kernel``: float32 on CUDA cores.  Counted in
  ``LAUNCHES["ssd_chunk_tiles_simt"]``; a call can ask for it
  (``force=SIMT``) to time it where the tensor cores would run.
- any other Q, N, P (above ``MAX_DIM``) or float16 B/C ->
  ``ssd_chunk_generic_kernel``: float32 on CUDA cores, a block a (chunk,
  128-row tile) and eight heads, G = C B^T made once for them over a window
  of up to 256 positions, each output the same fmaf chain as
  ``ssd_chunk_kernel``'s.  Counted in
  ``LAUNCHES["ssd_chunk_tiles_generic"]``; it takes every shape
  (``force=GENERIC``).

Routing of the state pass (``state_pass_route``), by shape, the dtypes of
C and the output and alignment; each kernel runs one block per (P slice,
head, batch row) walking the chunks in order:

- Q in {64, 128}, N a multiple of 16 up to ``MAX_DIM``, P a multiple of
  ``PASS_SLICE``, float32 or bf16 C and output, aligned ->
  ``ssd_state_pass_wgmma_kernel``: C . h on the tensor cores (wgmma), h
  as two bf16 pieces with bf16 C (two products), three pieces of h and
  of a float32 C (six products), float32 accumulation.  Counted in
  ``LAUNCHES["ssd_state_pass_wgmma"]``.
- every other shape with Q, N <= ``MAX_DIM``, P a multiple of 4 and rows
  of C a multiple of 16 bytes, float32 or bf16 C and output, aligned ->
  ``ssd_state_pass_kernel``: float32 on CUDA cores.  Counted in
  ``LAUNCHES["ssd_state_pass_simt"]``.
- everything else (wider Q or N, ragged P or rows of C, float16 C or
  output, inputs off 16-byte boundaries) -> ``ssd_state_pass_generic_kernel``:
  the same arithmetic with scalar loads, C and h staged in chunks and h
  kept in the final-state output.  Counted in
  ``LAUNCHES["ssd_state_pass_generic"]``.

B and C of different dtypes are cast to float32 (exactly, as the Pallas
kernel's ``astype``) and take the float32 route; so are dtx and cum in
another dtype, and the tile's y then returns in dtx's dtype.

``ssd_chunked`` is the port of ``ssd_chunked_pallas``, a drop-in for
``repro_torch.models.ssm.ssd_chunked``: padding to the chunk and the cumsum
stay plain torch, then for CUDA tensors exactly two kernels run, the tile
and the state pass.  Where the tile takes a tensor-core route and xh comes
in the dtype of B and C (the model's), the tile forms dtx = dt xh on load
(``ssd_chunk_tiles_xdt``) instead of reading a float32 dtx that plain
torch would first write.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import check, forward_only, need, on_cuda, ptr, stream


class Route(NamedTuple):
    kernel: str     # the CUDA kernel's name (as a profiler trace shows it)
    counter: str    # its key in LAUNCHES


WGMMA = Route("ssd_chunk_wgmma_kernel", "ssd_chunk_tiles_wgmma")
WGMMA_N16 = Route("ssd_chunk_wgmma_n16_kernel", "ssd_chunk_tiles_wgmma_n16")
SIMT = Route("ssd_chunk_kernel", "ssd_chunk_tiles_simt")
GENERIC = Route("ssd_chunk_generic_kernel", "ssd_chunk_tiles_generic")
STATE_PASS_WGMMA = Route("ssd_state_pass_wgmma_kernel", "ssd_state_pass_wgmma")
STATE_PASS_SIMT = Route("ssd_state_pass_kernel", "ssd_state_pass_simt")
STATE_PASS_GENERIC = Route("ssd_state_pass_generic_kernel",
                           "ssd_state_pass_generic")
LAUNCHES = {r.counter: 0 for r in (WGMMA, WGMMA_N16, SIMT, GENERIC,
                                   STATE_PASS_WGMMA, STATE_PASS_SIMT,
                                   STATE_PASS_GENERIC)}
TENSOR_CORE_TILES = (WGMMA, WGMMA_N16)   # one C entry, counted apart

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FIXED_DTYPES = (torch.float32, torch.bfloat16)   # the fixed-shape kernels'
MAX_DIM = 128   # largest chunk, state and head width ssd_chunk_kernel covers (kMaxDim)
WGMMA_CHUNKS = (64, 128)
WGMMA_DIMS = (64, 128)   # N and P the tensor-core tile takes
NARROW_N = 16            # the N of the narrow tensor-core tile (kNarrowN)
PASS_SLICE = 32          # P columns of one tensor-core pass block (kSlice)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def route(Q: int, N: int, P: int, dtype: torch.dtype,
          aligned: bool = True) -> Route:
    """The kernel a CUDA tile call of this shape and dtype of B and C
    launches (``aligned``: every input on a 16-byte boundary)."""
    if dtype not in _FIXED_DTYPES or max(Q, N, P) > MAX_DIM:
        return GENERIC
    if aligned and Q in WGMMA_CHUNKS and P in WGMMA_DIMS:
        if N == NARROW_N:
            return WGMMA_N16
        if N in WGMMA_DIMS and not (dtype == torch.float32
                                    and Q == N == P == MAX_DIM):
            return WGMMA
    return SIMT


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _bc_dtype(b_mat: torch.Tensor, c_mat: torch.Tensor) -> torch.dtype:
    """The dtype the kernels read B and C in: theirs when they share it,
    else float32 (both cast, exactly)."""
    return b_mat.dtype if b_mat.dtype == c_mat.dtype else torch.float32


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.float()


def cuda_route(dtx: torch.Tensor, cum: torch.Tensor, b_mat: torch.Tensor,
               c_mat: torch.Tensor, force: Route | None = None) -> Route:
    """Check the tile's inputs against what the kernels take and return the
    route a CUDA call takes (``force`` if given: the generic kernel takes
    every shape, ``ssd_chunk_kernel`` its own, a tensor-core one only its
    route's); raise on anything else.  Reads only shapes, dtypes, strides
    and addresses, so it runs on tensors of any device."""
    forward_only("ssd_chunk_tiles", dtx, cum, b_mat, c_mat)
    if dtx.dim() != 5:
        raise ValueError(f"dtx must be (B, nc, Q, H, P), got {tuple(dtx.shape)}")
    B, nc, Q, H, P = dtx.shape
    N = b_mat.shape[-1]
    if min(Q, N, P) < 1:
        raise ValueError(f"ssd_chunk_tiles takes Q, N, P >= 1, got Q={Q} "
                         f"N={N} P={P}")
    need(dtx, "dtx", (B, nc, Q, H, P), tuple(_DTYPES))
    need(cum, "cum", (B, nc, Q, H), tuple(_DTYPES))
    need(b_mat, "b_mat", (B, nc, Q, N), tuple(_DTYPES))
    need(c_mat, "c_mat", (B, nc, Q, N), tuple(_DTYPES))
    dt = _bc_dtype(b_mat, c_mat)
    # what is cast is new, and aligned; the rest must be
    kept = [t for t in (dtx, cum) if t.dtype == torch.float32]
    kept += [b_mat, c_mat] if dt == b_mat.dtype else []
    r = route(Q, N, P, dt, _aligned(*kept))
    if force is None or force in (r, GENERIC):
        return force or r
    if force == SIMT and route(Q, N, P, dt, False) == SIMT:
        return SIMT
    raise ValueError(f"ssd_chunk_tiles: {force.kernel} does not take Q={Q} "
                     f"N={N} P={P} {dt}")


def ssd_chunk_tiles(dtx: torch.Tensor, cum: torch.Tensor, b_mat: torch.Tensor,
                    c_mat: torch.Tensor, force: Route | None = None):
    """All intra-chunk outputs + per-chunk states.

    dtx (B, nc, Q, H, P) and cum (B, nc, Q, H); b_mat, c_mat (B, nc, Q, N);
    each float32, bf16 or float16 (accumulated in float32).  Returns
    (y_intra (B, nc, Q, H, P) in dtx's dtype, states (B, nc, H, N, P)
    float32).  ``force`` (CUDA tensors) overrides the shape's route, as
    ``cuda_route`` allows: ``SIMT`` or ``GENERIC`` runs a CUDA-core kernel
    where the tensor cores would (to time them side by side).
    """
    if not on_cuda(dtx, cum, b_mat, c_mat):
        return ref.ssd_chunk_ref(dtx, cum, b_mat, c_mat)
    r = cuda_route(dtx, cum, b_mat, c_mat, force)
    B, nc, Q, H, P = dtx.shape
    N = b_mat.shape[-1]
    out_dtype = dtx.dtype
    dtx, cum = _f32(dtx), _f32(cum)
    if _bc_dtype(b_mat, c_mat) != b_mat.dtype:
        b_mat, c_mat = b_mat.float(), c_mat.float()
    y = torch.empty_like(dtx)
    states = torch.empty((B, nc, H, N, P), dtype=torch.float32,
                         device=dtx.device)
    if not y.numel():
        return y.to(out_dtype), states
    LAUNCHES[r.counter] += 1
    lib = _build.load()
    launch = (lib.ssd_chunk_wgmma_launch if r in TENSOR_CORE_TILES
              else lib.ssd_chunk_launch if r == SIMT
              else lib.ssd_chunk_generic_launch)
    check(launch(ptr(dtx), ptr(cum), ptr(b_mat), ptr(c_mat),
                 _DTYPES[b_mat.dtype], B * nc, Q, H, N, P, ptr(y), ptr(states),
                 stream(dtx)), f"ssd_chunk_tiles ({r.kernel})")
    return y.to(out_dtype), states


def ssd_chunk_tiles_xdt(xh: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                        b_mat: torch.Tensor, c_mat: torch.Tensor):
    """``ssd_chunk_tiles(dt[..., None] * xh.float(), cum, b_mat, c_mat)``
    on a tensor-core route, with dtx formed on load: xh (B, nc, Q, H, P)
    in b_mat's dtype, dt (B, nc, Q, H) float32.  CUDA tensors only; for
    CPU tensors (and shapes no tensor-core route takes) call
    ``ssd_chunk_tiles`` on dtx instead."""
    if xh.dim() != 5:
        raise ValueError(f"xh must be (B, nc, Q, H, P), got {tuple(xh.shape)}")
    B, nc, Q, H, P = xh.shape
    N = b_mat.shape[-1]
    forward_only("ssd_chunk_tiles", xh, dt, cum, b_mat, c_mat)
    if not on_cuda(xh, dt, cum, b_mat, c_mat):
        raise ValueError("ssd_chunk_tiles_xdt runs on CUDA tensors only")
    r = route(Q, N, P, b_mat.dtype)
    if r not in TENSOR_CORE_TILES:
        raise ValueError(f"ssd_chunk_tiles_xdt: Q={Q} N={N} P={P} "
                         f"{b_mat.dtype} does not take a tensor-core route")
    need(xh, "xh", (B, nc, Q, H, P), (b_mat.dtype,))
    need(dt, "dt", (B, nc, Q, H))
    need(cum, "cum", (B, nc, Q, H))
    need(b_mat, "b_mat", (B, nc, Q, N), tuple(_DTYPES))
    need(c_mat, "c_mat", (B, nc, Q, N), (b_mat.dtype,))
    if not _aligned(xh, dt, cum, b_mat, c_mat):
        raise ValueError("ssd_chunk_tiles: the tensor-core tile's inputs must "
                         "start on 16-byte boundaries")
    y = torch.empty((B, nc, Q, H, P), dtype=torch.float32, device=xh.device)
    states = torch.empty((B, nc, H, N, P), dtype=torch.float32,
                         device=xh.device)
    if not y.numel():
        return y, states
    LAUNCHES[r.counter] += 1
    check(_build.load().ssd_chunk_wgmma_xdt_launch(
        ptr(xh), ptr(dt), ptr(cum), ptr(b_mat), ptr(c_mat),
        _DTYPES[b_mat.dtype], B * nc, Q, H, N, P, ptr(y), ptr(states),
        stream(xh)), f"ssd_chunk_tiles ({r.kernel}, dtx on load)")
    return y, states


def state_pass_route(Q: int, N: int, P: int, c_dtype: torch.dtype,
                     y_dtype: torch.dtype = torch.float32,
                     aligned: bool = True) -> Route:
    """The kernel a CUDA state-pass call of this shape, dtype of C and of
    the output launches (``aligned``: every input on a 16-byte boundary)."""
    for name, dt in (("c_mat", c_dtype), ("output", y_dtype)):
        if dt not in _DTYPES:
            raise TypeError(f"{name} dtype {dt} not in {tuple(_DTYPES)}")
    row_bytes = N * torch.finfo(c_dtype).bits // 8
    if (c_dtype not in _FIXED_DTYPES or y_dtype not in _FIXED_DTYPES
            or not aligned or max(Q, N) > MAX_DIM or P % 4 or row_bytes % 16):
        return STATE_PASS_GENERIC
    if Q in WGMMA_CHUNKS and N % 16 == 0 and P % PASS_SLICE == 0:
        return STATE_PASS_WGMMA
    return STATE_PASS_SIMT


def check_state_pass(y_intra: torch.Tensor, states: torch.Tensor,
                     cum: torch.Tensor, c_mat: torch.Tensor, length: int,
                     dtype: torch.dtype, route: Route | None = None) -> Route:
    """Check the state pass's inputs against what its kernels take and
    return the route a CUDA call takes (``route`` if given: the generic
    kernel takes every shape, ``ssd_state_pass_kernel`` its own, the
    tensor-core one only its route's); raise on anything else.  Runs on
    tensors of any device."""
    forward_only("ssd_state_pass", y_intra, states, cum, c_mat)
    if y_intra.dim() != 5:
        raise ValueError("y_intra must be (B, nc, Q, H, P), got "
                         f"{tuple(y_intra.shape)}")
    B, nc, Q, H, P = y_intra.shape
    N = c_mat.shape[-1]
    if min(Q, N, P) < 1:
        raise ValueError(f"ssd_state_pass takes Q, N, P >= 1, got Q={Q} "
                         f"N={N} P={P}")
    aligned = _aligned(y_intra, states, cum, c_mat)
    r = state_pass_route(Q, N, P, c_mat.dtype, dtype, aligned)
    if not 0 < length <= nc * Q:
        raise ValueError(f"length {length} outside 1..{nc * Q}")
    need(y_intra, "y_intra", (B, nc, Q, H, P))
    need(states, "states", (B, nc, H, N, P))
    need(cum, "cum", (B, nc, Q, H))
    need(c_mat, "c_mat", (B, nc, Q, N), tuple(_DTYPES))
    if route is None or route in (r, STATE_PASS_GENERIC):
        return route or r
    if route == STATE_PASS_SIMT and r != STATE_PASS_GENERIC:
        return STATE_PASS_SIMT   # it takes every shape the tensor cores take
    raise ValueError(f"ssd_state_pass: {route.kernel} does not take Q={Q} "
                     f"N={N} P={P} {c_mat.dtype} -> {dtype}")


def ssd_state_pass(y_intra: torch.Tensor, states: torch.Tensor,
                   cum: torch.Tensor, c_mat: torch.Tensor, length: int,
                   dtype: torch.dtype, route: Route | None = None):
    """The inter-chunk recurrence and output term (``ref.ssd_state_pass_ref``
    has the formulas).  Returns (y (B, length, H, P) in ``dtype``, final
    state (B, H, N, P) float32).  ``route`` (CUDA tensors) overrides the
    shape's route, as ``check_state_pass`` allows: ``STATE_PASS_SIMT`` or
    ``STATE_PASS_GENERIC`` runs a CUDA-core kernel where the tensor cores
    would (to time them side by side)."""
    if not on_cuda(y_intra, states, cum, c_mat):
        return ref.ssd_state_pass_ref(y_intra, states, cum, c_mat, length, dtype)
    r = check_state_pass(y_intra, states, cum, c_mat, length, dtype, route)
    B, nc, Q, H, P = y_intra.shape
    N = c_mat.shape[-1]
    y = torch.empty((B, length, H, P), dtype=dtype, device=y_intra.device)
    final = torch.empty((B, H, N, P), dtype=torch.float32,
                        device=y_intra.device)
    if not final.numel():
        return y, final
    LAUNCHES[r.counter] += 1
    lib = _build.load()
    launch = (lib.ssd_state_pass_wgmma_launch if r == STATE_PASS_WGMMA
              else lib.ssd_state_pass_launch if r == STATE_PASS_SIMT
              else lib.ssd_state_pass_generic_launch)
    check(launch(ptr(y_intra), ptr(states), ptr(cum), ptr(c_mat),
                 _DTYPES[c_mat.dtype], _DTYPES[dtype], B, nc, Q, H, N, P,
                 length, ptr(y), ptr(final), stream(y_intra)),
          f"ssd_state_pass ({r.kernel})")
    return y, final


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int = 128):
    """Chunked SSD through the tile and the state pass.

    xh (B, L, H, P); dt (B, L, H) positive steps; a (H,) negative rates;
    b_mat, c_mat (B, L, N).  Returns (y (B, L, H, P) in xh's dtype,
    final_state (B, H, N, P) float32).
    """
    B, L, H, P = xh.shape
    N = b_mat.shape[-1]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    nc = xh.shape[1] // Q

    if _bc_dtype(b_mat, c_mat) != b_mat.dtype:
        b_mat, c_mat = b_mat.float(), c_mat.float()
    xh_c = xh.reshape(B, nc, Q, H, P).contiguous()
    dt_c = dt.reshape(B, nc, Q, H).float().contiguous()
    b_c = b_mat.reshape(B, nc, Q, N).contiguous()
    c_c = c_mat.reshape(B, nc, Q, N).contiguous()
    cum = torch.cumsum(dt_c * a.float(), dim=2).contiguous()   # (B, nc, Q, H)

    if (on_cuda(xh_c, dt_c, cum, b_c, c_c) and xh.dtype == b_c.dtype
            and route(Q, N, P, b_c.dtype, _aligned(xh_c, dt_c, cum, b_c, c_c))
            in TENSOR_CORE_TILES):
        y_intra, s_chunk = ssd_chunk_tiles_xdt(xh_c, dt_c, cum, b_c, c_c)
    else:
        dtx = (dt_c[..., None] * xh_c.float()).contiguous()
        y_intra, s_chunk = ssd_chunk_tiles(dtx, cum, b_c, c_c)
    return ssd_state_pass(y_intra, s_chunk, cum, c_c, L, xh.dtype)
