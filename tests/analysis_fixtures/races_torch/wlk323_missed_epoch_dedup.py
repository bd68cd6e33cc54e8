# expect: code=WLK323
"""Seeded protocol bug: a crash-replay dedup watermark with an
off-by-one (``seq < delivered`` where the channel uses ``seq <=``).

A producer crash rewinds the serve counter and re-offers everything
since the last ack; whether the consumer already drained some of those
steps is schedule-dependent.  With the buggy comparison the replayed
copy of the LAST drained step passes the dedup check and is delivered
twice -- but only on schedules where the consumer drained at least one
item before the crash, which is exactly what the explorer enumerates.
The duplicated delivery trips the consumer's exactly-once assertion and
reports WLK323 with a replayable schedule ID."""

from repro_torch.analysis.lockcheck import make_condition

CODE = "WLK323"
BUDGET = 128
_SKIP = object()


class _MiniChannel:
    """A depth-unbounded mini-channel with the crash-replay protocol and
    the dedup watermark re-broken."""

    def __init__(self):
        self.cv = make_condition("leaf:mini")
        self.queue = []
        self.delivered = 0
        self.done = False

    def offer(self, seq):
        with self.cv:
            self.queue.append(seq)
            self.cv.notify()

    def crash(self):
        # quarantine: the in-flight queue is dropped; the restarted
        # incarnation will re-offer from the last ack (seq 1)
        with self.cv:
            self.queue.clear()

    def finish(self):
        with self.cv:
            self.done = True
            self.cv.notify_all()

    def get(self):
        with self.cv:
            while not self.queue and not self.done:
                self.cv.wait()
            if not self.queue:
                return None
            seq = self.queue.pop(0)
            if seq < self.delivered:   # BUG: replayed seq==delivered slips through (should be <=)
                return _SKIP
            self.delivered = seq
            return seq


def build():
    ch = _MiniChannel()
    got = []

    def producer():
        ch.offer(1)
        ch.offer(2)
        ch.crash()
        for seq in (1, 2, 3):
            ch.offer(seq)
        ch.finish()

    def consumer():
        while True:
            seq = ch.get()
            if seq is None:
                break
            if seq is _SKIP:
                continue
            got.append(seq)
        assert got == [1, 2, 3], \
            f"replay broke exactly-once delivery: {got}"

    return [("producer", producer), ("consumer", consumer)]
