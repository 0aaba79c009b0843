"""fold_ms: the mean ms from a query's readback to its return (its
sregex.fold spans, over the untraced window's queries: spans.py): the
validation, any repair walk and the stats; the card is idle throughout."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "sregex.fold")
