"""``device_idle_pct``: the share of the traced stretch of the window in
which no kernel, copy or memset ran on a card, from the profiler's trace;
on several cards each card's share, averaged over the cards
(``tracing.reduce``'s ``busy_s`` is the mean of each card's busy time)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
