"""100 minus the share of the traced window in which a kernel, copy or set
ran on the card (the union of their intervals), in %, read in the SLAM
cells: ``harness.device_idle_pct``."""

from mfbench import harness


def read(ctx):
    return harness.device_idle_pct(ctx)
