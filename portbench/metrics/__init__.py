"""Metric readers, one file a metric: ``metrics/<name>.py`` with
``read(ctx)`` → the metric's value, or None where the run holds
nothing to read (the harness then leaves the metric out of the line).

``ctx`` carries the run: ``analysis`` (the configuration's analysis),
``setup_s``, ``window_s`` (host clock, window start to the end of its
last analysis), ``frames`` (every frame of the window's analyses),
``phases`` (each analysis's ``results.observability["phases"]``),
``trace`` (:func:`portbench.devtrace.summarise` of the traced window,
or None) and ``least_time_s()`` (the least device time of the window's
work, :mod:`portbench.roofline`).
"""


def rate(ctx, analysis):
    """Frames a second over the window."""
    if ctx.analysis != analysis:
        return None
    return ctx.frames / ctx.window_s


def phase_share(ctx, phase, analysis):
    """The window's share, in %, spent in the program's ``phase`` timer
    (summed over its analyses)."""
    if ctx.analysis != analysis:
        return None
    seconds = [p[phase]["seconds"] for p in ctx.phases if phase in p]
    if not seconds:
        return None
    return 100.0 * sum(seconds) / ctx.window_s


def roofline_share(ctx, analysis):
    """The least time of the window's work over the device time of
    every kernel in the traced window, in %."""
    if ctx.analysis != analysis or not ctx.trace:
        return None
    if ctx.trace["kernel_s"] <= 0:
        return None
    return 100.0 * ctx.least_time_s() / ctx.trace["kernel_s"]


def idle_share(ctx, analysis):
    """1 − the union of device work over the traced window, in %."""
    if ctx.analysis != analysis or not ctx.trace:
        return None
    t = ctx.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
