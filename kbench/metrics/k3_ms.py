"""K3: the profiler's mean device time of one launch of the wave-batched
cycle kernel (``solver/cycle_wide_cuda.cu wave_cycle_kernel``), in ms."""

from kbench.devtrace import kernel_mean_ms


def read(run):
    if run["profile"] is None:
        return None
    count, ms = kernel_mean_ms(run["profile"], lambda name: run["kernels"]["k3"] in name)
    return ms if count else None
