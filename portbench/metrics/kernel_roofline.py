"""``kernel_roofline``: the least time the traced calls' results need, their
bytes (``portbench.work``: each input block read once, each output block
written once) over one card's published HBM bandwidth, as a share of the
summed device time of every kernel in those calls, from the profiler's
trace. Both are card-seconds: on several cards the kernels' times are
summed over the cards, and the least time is what one card would need for
all the bytes, so the share is of the cards' combined bandwidth."""
from portbench import work


def read(run):
    t = run.trace
    if not t or not t["calls"] or t["kernel_s"] <= 0:
        return None
    least = work.least_seconds(run.needed_bytes * t["calls"], run.device_name)
    if least is None:
        return None
    return 100.0 * least / t["kernel_s"]
