"""``goodput_GBps``: the bytes the caller asked for (archived or read-back
object blocks, or rebuilt shards), complete on the card within the window,
over the whole window on the host's clock, in 1e9 bytes a second."""


def read(run):
    if run.calls == 0 or run.window_s <= 0:
        return None
    return run.calls * run.useful_bytes / run.window_s / 1e9
