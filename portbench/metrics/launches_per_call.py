"""``launches_per_call``: the kernels that ran on the card during the traced
calls, from the profiler's trace, whatever launched them, over the number
of traced calls."""


def read(run):
    t = run.trace
    if not t or not t["calls"] or not t["kernels"]:
        return None
    return t["kernels"] / t["calls"]
