"""Per-device tuning registry.

Port of ``maskfusion_tpu/utils/tuning.py`` (the reference's GPUConfig
per-GPU-name tables, Core/Utils/GPUConfig.h:50-146), keyed on the torch
device name.  The engine reads ONE DeviceTuning at construction and consumes
it in bucket sizing and the diagnostics flush interval.  No card has tuned
entries yet: every name gets the defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class DeviceTuning:
    # bucketing policy for per-surfel passes (mapping/surfel_map.choose_bucket)
    min_bucket_global: int = 1 << 18
    min_bucket_object: int = 1 << 16
    headroom_global: int = 81920
    headroom_object: int = 16384
    # diagnostics fetch interval in frames (one device->host copy each)
    diag_interval: int = 8


# keyed by prefixes of torch.cuda.get_device_name() (or "cpu")
_REGISTRY: Dict[str, DeviceTuning] = {}

_DEFAULT = DeviceTuning()


def device_name(device: torch.device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def get_tuning(device: torch.device) -> DeviceTuning:
    name = device_name(device).lower()
    for prefix, tuning in _REGISTRY.items():
        if name.startswith(prefix.lower()):
            return tuning
    return _DEFAULT
