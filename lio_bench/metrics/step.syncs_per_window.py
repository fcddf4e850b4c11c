"""Blocking host calls per traced window: stream, device and event
synchronisations and synchronous copies (each read of a device value to the
host, as `.cpu()`, `.item()` or `bool()` of a tensor, makes one)."""

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")


def read(ctx):
    if ctx.events is None or not ctx.traced_windows:
        return None
    if not any(e.kind == "runtime" for e in ctx.events):
        return None
    n = sum(1 for e in ctx.events if e.kind == "runtime" and e.name in SYNCS)
    return n / ctx.traced_windows
