"""Median wait in the queue, from a request's due time to its
admission, over the requests due in the window, in ms."""

import statistics


def read(ctx):
    waits = ctx.get("queue_wait_s") or []
    return 1e3 * statistics.median(waits) if waits else None
