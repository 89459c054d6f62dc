"""Host waits on the device a traced pass: the runtime's stream and event
synchronizations and blocking copies (each read-back of a size or flag),
from the profiler's host events; the harness's own device
synchronizations (cudaDeviceSynchronize) are not counted."""

#: runtime calls in which the host waits for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")


def read(ctx):
    if ctx.trace is None:
        return None
    waits = sum(e.cat == "cuda_runtime" and e.name in SYNC_CALLS for e in ctx.trace.host)
    return waits / ctx.trace.passes
