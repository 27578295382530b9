"""Kernel launches (``cudaLaunchKernel``, ``cuLaunchKernel*``) the host
issued in the traced training steps, a step."""


def read(ctx):
    p = ctx.profile
    if not p or not p["units"] or p["launches"] is None:
        return None
    return p["launches"] / p["units"]
