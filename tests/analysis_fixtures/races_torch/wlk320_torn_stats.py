# expect: code=WLK320
"""Seeded race (the torn-stats bug, re-introduced): two transport
threads bump the same stats counter with an unlocked read-modify-write.

The explorer must flag the HB-unordered accesses as WLK320 -- the two
``add`` calls carry no lock and no happens-before edge, so even the
sequential schedules are racy (FastTrack semantics: unordered, not
merely simultaneous)."""

from repro_torch.analysis.explore.instrument import TrackedCell

CODE = "WLK320"
BUDGET = 16


def build():
    stats = TrackedCell("stats.nbytes", 0)

    def producer():
        stats.add(4096)

    def drainer():
        stats.add(4096)

    return [("producer", producer), ("drainer", drainer)]
