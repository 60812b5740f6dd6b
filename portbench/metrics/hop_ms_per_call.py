"""``hop_ms_per_call``: the device time of the wire's copies between cards in
the traced calls, in card-milliseconds a call: the profiler's peer copies
(``Memcpy PtoP``, as ``tracing.short`` names them) among the stretch's
device operations, summed over the cards (``tracing.reduce``), over the
traced calls. None where the trace holds no peer copy: one card, or a
program whose chain does not cross cards."""

PEER_COPY = "Memcpy PtoP"


def read(run):
    t = run.trace
    if not t or not t["calls"]:
        return None
    seconds = sum(s for name, s in t["breakdown"]["device_ops"] if name.startswith(PEER_COPY))
    return 1e3 * seconds / t["calls"] if seconds > 0 else None
