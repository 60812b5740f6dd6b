"""``dispatch_ms``: the host's time in the entry-point call, from the call to
its return and before the synchronise, as a mean over the window's calls
outside the traced stretch (the profiler slows the host inside it)."""


def read(run):
    if not run.dispatch_ms:
        return None
    return sum(run.dispatch_ms) / len(run.dispatch_ms)
