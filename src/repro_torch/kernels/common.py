"""What every kernel wrapper shares: device dispatch, input checks and the
launch plumbing of the ctypes-bound library (``repro_torch.kernels.build``).

A wrapper runs its plain version only when its tensors lie on the CPU
(``on_cuda`` is False); for CUDA tensors it checks them with ``need``,
launches on the current stream and raises through ``check`` if the C entry
returns a CUDA error.
"""

from __future__ import annotations

from typing import Optional

import torch


def on_cuda(*tensors) -> bool:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def need(t: torch.Tensor, name: str, shape, dtypes=(torch.float32,)):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def forward_only(name: str, *tensors) -> None:
    """The kernels have no backward yet: refuse inputs that need one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel is forward-only; call "
                           "it on tensors that do not require grad")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# the current stream's handle without building a torch.cuda.Stream (a few
# microseconds of host time a launch); CPU builds of torch have neither
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of ``t``'s device."""
    if _raw_stream is not None:
        return _raw_stream(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")
