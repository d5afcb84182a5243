"""Device resolution shared by the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  With
no GPU and no explicit ``"cpu"`` they raise: the port never quietly
runs on the CPU.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def _set_cuda_numerics() -> None:
    # Full-precision float32 on the card, as on the CPU and in the JAX
    # reference: a float32 matmul may otherwise run in TF32 (cuDNN's
    # default is True), which keeps only ~3 decimal digits.  bf16
    # matmuls accumulate in float32 end to end (no reduced-precision
    # split-K reductions), matching the reference's
    # preferred_element_type=float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for (or
    defaulted to) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        _set_cuda_numerics()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.type == "cpu" or a.index == b.index)


def check_on(t: torch.Tensor, device: torch.device,
             what: str) -> None:
    if not same_device(t.device, device):
        raise ValueError(f"{what} is on {t.device}, expected {device}")


def to_device(a: Union[np.ndarray, torch.Tensor],
              device: torch.device) -> torch.Tensor:
    """A copy of host data on ``device``.  On the card it goes through
    pinned memory, enqueued on the current stream: a copy from pageable
    memory would make the host wait for the stream to drain.  The source
    may be changed as soon as this returns."""
    t = torch.as_tensor(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)
