"""output_tokens_per_s: every output token delivered inside the window
over the window's seconds."""
from portbench import stats


def read(run):
    return stats.tokens_per_s(run["records"], run["window"])
