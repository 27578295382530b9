"""Carry engine state across packages.

The system has no weights: its state is the surfel map, the pose and the
predictions.  A JAX ``MapState`` flattened to numpy arrays — the map's
fields (pos, conf, color, init_time, last_seen, normal, radius, count) and
the state's (pose, last_delta, pred_vmap, pred_nmap, pred_rgb,
so3_intensity) under those names — becomes the port's ``MapState``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from maskfusion_tpu_torch.engine import MapState
from maskfusion_tpu_torch.mapping.surfel_map import SurfelMap

MAP_FIELDS = SurfelMap._fields
STATE_FIELDS = tuple(f for f in MapState._fields if f != "map")


def map_state_from_numpy(d: Dict[str, np.ndarray], device) -> MapState:
    def t(name):
        a = np.asarray(d[name])
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        # a copy: the engine updates the map in place, and the source
        # arrays may be read-only views of another framework's buffers
        return torch.tensor(a, device=device)

    m = SurfelMap(*(t(f) for f in MAP_FIELDS[:-1]),
                  count=t("count").to(torch.int32).reshape(()))
    return MapState(m, *(t(f) for f in STATE_FIELDS))

