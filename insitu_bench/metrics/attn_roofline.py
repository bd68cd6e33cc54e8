"""attn_roofline (%): the least time of the K3 launches of the profiled
sub-window (the larger of their operations at the bf16 rate and their bytes
at the bandwidth, ``roofline.zamba2.attn_bound_s``) over their device time
in the trace.  The run's raw result gives one launch's work under
``attn_work``."""

from insitu_bench import roofline
from insitu_bench.roofline import zamba2


def read(raw):
    trace, pk = raw.get("trace"), roofline.peaks(raw.get("device_name", ""))
    if trace is None or pk is None or "attn_work" not in raw:
        return None
    bound = spent = 0.0
    for kernel, (flops, moved) in raw["attn_work"].items():
        seconds, count = trace.seconds_of(kernel)
        bound += count * zamba2.attn_bound_s(flops, moved, pk)
        spent += seconds
    return 100.0 * bound / spent if spent else None
