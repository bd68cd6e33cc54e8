# expect: code=WLK321
"""Seeded deadlock: the classic AB-BA lock-order inversion between two
leaf locks.  The runtime lock-order recorder (WLK310) can only flag this
if a run happens to interleave badly; the explorer proves it by
*constructing* the interleaving and reports WLK321 with a replayable
schedule ID."""

from repro_torch.analysis.lockcheck import make_lock

CODE = "WLK321"
BUDGET = 32


def build():
    a = make_lock("leaf:a")
    b = make_lock("leaf:b")

    def t_ab():
        with a:
            with b:
                pass

    def t_ba():
        with b:
            with a:
                pass

    return [("t_ab", t_ab), ("t_ba", t_ba)]
