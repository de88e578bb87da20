"""host_syncs_per_step: the CUDA runtime's blocking synchronizations
(`cudaStreamSynchronize`, `cudaDeviceSynchronize`, `cudaEventSynchronize`:
a blocking copy between host and device, a host read of a device value)
that the traced steps made, over the traced steps (`spans.step_syncs`).
The count is the runtime's own record; the device-wide synchronizations
that close the trace (the harness's and the profiler's) are left out. Read only where the program marks its steps
(`fps.step`)."""

from benchmark import spans

SPAN = "fps.step"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    n = spans.step_syncs(tr, SPAN)
    return None if n is None else n / tr.n_steps
