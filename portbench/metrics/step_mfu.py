"""Model step: the share of the card's peak that the whole step reaches, in
%: the model's operations for one forward of every stream's scan (counted
from the architecture at ``num_pts`` rows a stream, ``counts.step_ops``),
each layer at the peak of the precision it runs in, summed as ideal
seconds, over the mean step time (host clock) outside the profiled slice. A
restart step's extra bootstrap counts as time, not as work."""

from portbench.counts import rows, step_ops
from portbench.peaks import ideal_s


def read(ctx):
    t = [r[0] for r in ctx["records"] if not r[3]]
    if not t:
        return None
    ops = step_ops(ctx["cfg"])
    ideal = ideal_s({p: n * rows(ctx) for p, n in ops.items()})
    return 100.0 * ideal / (sum(t) / len(t))
