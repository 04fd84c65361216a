"""End to end: the 95th percentile of every step of the window (host
clock, from handing the batch of host scans to the runner until the
outputs ``cli.infer`` reads are on the host), in ms."""

import numpy as np


def read(ctx):
    return float(np.percentile([r[0] for r in ctx["records"]], 95)) * 1e3
