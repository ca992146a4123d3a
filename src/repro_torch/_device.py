"""Device selection and device facts shared by the port's entry points."""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    the CPU runs only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless told otherwise, and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch path")
    return dev


#: Streaming multiprocessors of the H100 SXM: the count the kernels' launch
#: plans size for unless they are given the device's own (`sm_count`).
SM_COUNT = 132


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once a device; the
    read makes no host sync); SM_COUNT for another device (the meta
    device of a dry run)."""
    if torch.device(device).type != "cuda":
        return SM_COUNT
    return torch.cuda.get_device_properties(device).multi_processor_count
