"""kernels_per_step.general (kernels): kernel launches the program makes
inside its ``pls.general_train.launch`` spans (the C call of the
general-cost kernel B3), over the steps those calls queue (the program's
counter ``general_train.steps``, read as ``general_train_steps`` of the
cell's shapes). A launch is the host's runtime call, since the kernels run
on the device after the span has ended. None where the trace holds no such
span or launch, or the program keeps no such counter."""

SPAN = "pls.general_train.launch"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def read(trace, shapes):
    steps = shapes.get("general_train_steps")
    spans = [(o.start_ns, o.end_ns) for o in trace.host if o.name == SPAN]
    if not steps or not spans:
        return None
    launches = sum(1 for o in trace.host if o.name.startswith(LAUNCHES)
                   and any(a <= o.start_ns <= b for a, b in spans))
    return launches / steps if launches else None
