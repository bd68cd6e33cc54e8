# expect: code=WLK322
"""Seeded lost wakeup: the producer publishes the flag and notifies
WITHOUT taking the condition's lock, so the notify can land in the gap
between the consumer's predicate check and its ``wait`` -- the wakeup is
lost and the consumer parks forever.

Real ``threading.Condition`` turns an un-held ``notify`` into a hard
``RuntimeError``; the explorer's model CV deliberately permits it (lossy
wake of current waiters only) exactly so this hazard is *explorable*:
the bad interleaving needs one preemption and reports WLK322."""

from repro_torch.analysis import lockcheck
from repro_torch.analysis.lockcheck import make_condition

CODE = "WLK322"
BUDGET = 32


def build():
    cv = make_condition("leaf:flag")
    state = {"flag": False}

    def consumer():
        with cv:
            while not state["flag"]:
                # the check-to-wait gap the missing lock leaves open
                lockcheck.sched_point("predicate-to-wait gap",
                                      key=("flag", 0))
                cv.wait()

    def producer():
        # BUG: flag store + notify outside the CV's lock
        state["flag"] = True
        cv.notify()

    return [("consumer", consumer), ("producer", producer)]
