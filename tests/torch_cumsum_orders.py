"""How far the running sums under the JAX package's segment sums
(maskfusion_tpu/ops/sort_utils.segment_sum_dense: one float32 cumsum over
all records) depend on the summation order of the library that takes them.

    python -m tests.torch_cumsum_orders [rows] [columns] [seed]

Takes the column cumsum of one seeded float32 matrix (default 20000 x 8,
uniform in [0, 2)) with jnp.cumsum, torch.cumsum and numpy's sequential
np.add.accumulate, and prints for each pair the share of entries that agree
bit for bit and the largest difference.  On the CPU, seconds.
"""

from __future__ import annotations

import sys

import conftest  # noqa: F401  (JAX on the CPU, as the tests run it)
import jax.numpy as jnp
import numpy as np
import torch


def cumsums(rows: int, cols: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    mat = (2.0 * rng.random((rows, cols))).astype(np.float32)
    return {"jax": np.asarray(jnp.cumsum(jnp.asarray(mat), axis=0)),
            "torch": torch.cumsum(torch.from_numpy(mat), dim=0).numpy(),
            "numpy": np.add.accumulate(mat, axis=0, dtype=np.float32)}


def main(argv) -> None:
    defaults = ["20000", "8", "0"]
    rows, cols, seed = (int(a) for a in argv + defaults[len(argv):])
    out = cumsums(rows, cols, seed)
    names = list(out)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            same = float((out[a] == out[b]).mean())
            diff = float(np.abs(out[a].astype(np.float64) - out[b]).max())
            print(f"{a} vs {b}: {same:.1%} of {rows}x{cols} entries equal, "
                  f"max |difference| {diff:.3g}")


if __name__ == "__main__":
    main(sys.argv[1:])
