"""``call_p95_ms``: the 95th percentile over all calls of the window of one
call's time, from a CUDA event recorded at the entry call to one recorded
after its return, both read on the device's clock once the synchronise has
returned (a call is shorter than the host clock's resolution allows). On
several cards both events are on the first card, and the second waits for
the work queued on every other card's current stream (``harness.joiner``)."""
import numpy as np


def read(run):
    if not run.call_ms:
        return None
    return float(np.percentile(np.asarray(run.call_ms), 95))
