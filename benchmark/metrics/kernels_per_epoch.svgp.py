"""kernels_per_epoch.svgp (kernels): kernels the device ran inside the calls'
spans of a ``fit_svgp`` cell, per epoch. None where the trace shows no
kernel."""

from benchmark.harness.readers import call_kernels


def read(trace, shapes):
    kernels = call_kernels(trace)
    return kernels / trace.work if kernels and trace.work > 0 else None
