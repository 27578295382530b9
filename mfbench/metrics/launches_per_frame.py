"""Kernel launches (``cudaLaunchKernel``, ``cuLaunchKernel*``) the host
issued in the traced frames, a frame."""


def read(ctx):
    p = ctx.profile
    if not p or not p["units"] or p["launches"] is None:
        return None
    return p["launches"] / p["units"]
