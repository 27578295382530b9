"""Stream, event and device synchronises the host made in the traced
frames, a frame."""


def read(ctx):
    p = ctx.profile
    if not p or not p["units"] or p["syncs"] is None:
        return None
    return p["syncs"] / p["units"]
