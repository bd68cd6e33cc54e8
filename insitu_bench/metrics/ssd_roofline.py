"""ssd_roofline (%): the least time of the K4 launches of the profiled
sub-window (the larger of their operations at the 3xTF32 rate and their
bytes at the bandwidth) over their device time in the trace."""

from insitu_bench import roofline


def read(raw):
    trace, pk = raw.get("trace"), roofline.peaks(raw.get("device_name", ""))
    if trace is None or pk is None or "kernel_work" not in raw:
        return None
    bound = spent = 0.0
    for kernel, (flops, moved) in raw["kernel_work"].items():
        seconds, count = trace.seconds_of(kernel)
        bound += count * roofline.ssd_bound_s(flops, moved, pk)
        spent += seconds
    return 100.0 * bound / spent if spent else None
