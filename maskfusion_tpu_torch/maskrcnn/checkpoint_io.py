"""The repository's Mask R-CNN checkpoint format, in numpy only.

Port of ``maskfusion_tpu/maskrcnn/checkpoint_io.py``: a flat float16 .npz of
the flax parameter tree, one array a "/"-joined path, plus a JSON
``__meta__``.  ``load_params`` returns the same nested tree of flax names
(float32) as the JAX package's; ``maskfusion_tpu_torch.convert.
maskrcnn_state_dict`` carries it into the port's model.
"""

from __future__ import annotations

import json

import numpy as np


def _flatten(params, prefix=""):
    out = {}
    if hasattr(params, "items"):
        for k, v in params.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(params)
    return out


def save_params(path: str, params, meta: dict | None = None):
    """Write a nested tree of arrays (flax names) as float16."""
    arrays = {k: v.astype(np.float16) for k, v in _flatten(params).items()}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_params(path: str):
    """Returns (nested float32 param dict, meta dict)."""
    meta = {}
    tree: dict = {}
    with np.load(path) as data:
        for k in data.files:
            if k == "__meta__":
                meta = json.loads(bytes(data[k]).decode())
                continue
            node = tree
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[k].astype(np.float32)
    return tree, meta
