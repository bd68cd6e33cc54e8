"""insitu.snapshot_ms: the trainer's snapshot (a copy of every parameter
and its h5 write, between two waits for the stream), averaged over the
snapshots of the window."""


def read(raw):
    ms = raw.get("snapshot_ms")
    return sum(ms) / len(ms) if ms else None
