"""summary_ms: the mean ms a query spends enqueueing the validation
summary's ops after the kernel's launch (its sregex.summary spans, over
the untraced window's queries: spans.py); it overlaps the kernel on the
card."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "sregex.summary")
