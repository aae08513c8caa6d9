"""K2: the profiler's mean device time of one launch of the per-pod int32
cycle kernel (``solver/cycle_cuda.cu cycle_kernel<int32_t>``), in ms."""

from kbench.devtrace import kernel_mean_ms


def read(run):
    if run["profile"] is None:
        return None
    count, ms = kernel_mean_ms(run["profile"], lambda name: run["kernels"]["k2"] in name
                               and run["kernels"]["k3"] not in name)
    return ms if count else None
