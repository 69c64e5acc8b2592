"""factor_ms_per_epoch.svgp (ms): device milliseconds in Cholesky
factorisations inside the calls' spans of a ``fit_svgp`` cell, per epoch:
cuSOLVER's Cholesky runs as kernels named ``getrf_wo_pivot`` (``potrf``
where its version names them so). None where the trace shows none."""

NAMES = ("getrf_wo_pivot", "potrf")


def read(trace, shapes):
    ops = [o for o in trace.call_ops() if any(k in o.name.lower() for k in NAMES)]
    if not ops or trace.work <= 0:
        return None
    return 1e3 * trace.device_s(ops) / trace.work
