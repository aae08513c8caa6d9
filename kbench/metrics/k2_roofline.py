"""K2: the share of its roofline, in %: the cycle's bound (``kbench/roofline.py``
over the benchmark's own model at each profiled step) over the profiler's
mean K2 launch time."""

from kbench.devtrace import kernel_mean_ms
from kbench.roofline import cycle_bound_ms
from kbench.stats import mean


def read(run):
    if run["profile"] is None or not run["profiled_states"]:
        return None
    count, ms = kernel_mean_ms(run["profile"], lambda name: run["kernels"]["k2"] in name
                               and run["kernels"]["k3"] not in name)
    if not count:
        return None
    return mean([cycle_bound_ms(s) for s in run["profiled_states"]]) / ms * 100
