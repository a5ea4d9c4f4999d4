"""device.idle_pct: the share of the profiled window over whole pricings in
which no kernel, copy or fill ran on the card, in %."""


def read(ctx: dict):
    trace = ctx.get("trace") or {}
    if not trace.get("busy_s") or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
