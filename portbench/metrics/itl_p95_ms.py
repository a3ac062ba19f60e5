"""itl_p95_ms: 95th percentile of the gap between output tokens, one
gap per token of every delivery after a request's first inside the window
(the delivery's interval over its tokens)."""
from portbench import stats


def read(run):
    xs = stats.itls(run["records"], run["window"])
    return stats.percentile(xs, 95) * 1e3 if xs else None
