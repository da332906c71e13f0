"""95th percentile of the time to first token over every request
completed in the window (host clock: a batch's start to its answer)."""

import statistics


def read(run):
    values = [r["ttft_s"] * 1e3 for r in run.records
              for _ in range(r["rows"]) if r.get("ttft_s") is not None]
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[94]
