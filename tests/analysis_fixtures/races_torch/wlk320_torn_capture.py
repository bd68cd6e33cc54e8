# expect: code=WLK320
"""Seeded race (the torn-capture bug, re-introduced): a reader
captures the shared payload buffer BEFORE the hand-off protocol orders
it, then reads through the stale capture while the writer mutates the
same buffer in place (the pre-CoW behavior: no copy before write).

The fixed protocol copies on first write under the share lock, so reader
and writer never touch one buffer unordered; this fixture drops both the
copy and the lock, and the shadow-state checker must report WLK320 with
the reader's and the writer's stacks."""

from repro_torch.analysis.explore.instrument import TrackedCell

CODE = "WLK320"
BUDGET = 16


def build():
    share = {"buf": TrackedCell("payload", 0)}
    seen = []

    def writer():
        # BUG: mutates the shared buffer in place instead of copying
        share["buf"].write(7)

    def reader():
        buf = share["buf"]     # captures the buffer, not a snapshot
        seen.append(buf.read())

    return [("writer", writer), ("reader", reader)]
