"""Device layer: the share of the profiled slice in which no operation ran
on the card, in %."""


def read(ctx):
    view = ctx["trace"]
    if view is None or view.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
