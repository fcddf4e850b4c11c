"""Kernel launches (CUDA runtime and driver launch calls, graph launches
counted once) per traced window."""

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")


def read(ctx):
    if ctx.events is None or not ctx.traced_windows:
        return None
    n = sum(1 for e in ctx.events if e.kind == "runtime" and e.name in LAUNCHES)
    return n / ctx.traced_windows if n else None
