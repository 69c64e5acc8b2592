"""kernels_per_step.off (kernels): kernels the device ran inside the calls'
spans of a ``train_pls`` cell on the ``off`` tier, per Langevin step (the
window's particle updates over J). None where the trace shows no kernel."""

from benchmark.harness.readers import call_kernels


def read(trace, shapes):
    kernels = call_kernels(trace)
    steps = trace.work / shapes["j"]
    return kernels / steps if kernels and steps > 0 else None
