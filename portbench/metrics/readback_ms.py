"""readback_ms: the mean ms a query's host is blocked on the card (its
sregex.readback spans, over the untraced window's queries: spans.py):
the rest of the kernel, the summary's device time and the 40-byte
copy."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "sregex.readback")
