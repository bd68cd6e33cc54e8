"""train.mfu (%): the model operations of the window's training steps
(from the shapes; the recompute not counted) over the time they took and
the card's published bf16 peak.  In a traced run only the steps that ended
before the profiled sub-window count, so the profiler's cost is not in it."""

from insitu_bench import roofline


def read(raw):
    pk = roofline.peaks(raw.get("device_name", ""))
    if pk is None or not raw.get("steps"):
        return None
    ends = raw["step_ends"]
    if raw.get("trace") is not None:
        ends = [e for e in ends if e <= raw["trace"].t0]
    if not ends:
        return None
    rate = raw["model_flops_per_step"] * len(ends) / (ends[-1] - raw["t0"])
    return 100.0 * rate / pk["bf16_flops"]
