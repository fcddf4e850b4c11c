"""Host time per window outside the device step, over the untraced windows
that follow the trace in a `--trace 1` run (the profiler would stretch
them): the program's stage timers `assemble`, `h2d` and `resolve_host`,
plus the harness's clock around `add_imu`/`add_scan` (with the scan's
decode) and around `spin_once` outside `step_window`."""


def read(ctx):
    if not ctx.host_windows:
        return None
    return (sum(ctx.host_stage_ms.values()) + ctx.host_harness_s * 1e3) / ctx.host_windows
