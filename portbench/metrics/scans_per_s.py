"""End to end: scans whose outputs reached the host in the window, over the
window's wall time (host clock, from the first step's start to the last
step's end)."""


def read(ctx):
    return len(ctx["records"]) * ctx["streams"] / ctx["wall_s"]
