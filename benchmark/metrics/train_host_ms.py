"""train_host_ms (ms): the milliseconds a ``train_pls`` call holds the
device idle inside the benchmark's span around it, averaged over the
window's calls: the tier's resolution, the set-up of its system, the graph's
capture, the host's reads of the stop flag and of the energies."""

from benchmark.harness.readers import host_ms_per_call


def read(trace, shapes):
    return host_ms_per_call(trace)
