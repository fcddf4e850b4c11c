"""The grouped KNN kernel's share of its roofline over the traced windows:
the least time its inputs need at the card's published peaks
(roofline.topk_bound, summed over its launches) over its device time in
the trace (summed over its kernel records)."""

from lio_bench.roofline import peaks, topk_bound

KERNEL = "knn_grouped_kernel"


def read(ctx):
    if ctx.events is None or not ctx.knn_calls:
        return None
    peak = peaks(ctx.device_kind)
    spans = [e.end - e.start for e in ctx.events if e.kind == "kernel" and KERNEL in e.name]
    if peak is None or not spans:
        return None
    bound_ms = sum(topk_bound(b, q, s, k, peak)[0] for b, q, s, k in ctx.knn_calls)
    return 100.0 * bound_ms / (sum(spans) / 1e6)
