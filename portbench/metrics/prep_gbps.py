"""prep_gbps: the corpus bytes the program's preps took over their
time, in decimal GB/s: the process's sregex.prep span totals (value over
ns; the set-up's preps of the ring's shards).  A resident corpus's prep
span (PreparedCorpus.for_tables) ends once the card holds the prep, so
it holds the upload and the prep's device work.  Read only where the
program recorded the untraced window's queries (spans.py)."""

from portbench.spans import plain_queries, recorder


def read(run):
    if not plain_queries(run):
        return None
    prep = recorder().span_totals().get("sregex.prep")
    if prep is None or prep.ns <= 0:
        return None
    return prep.value / prep.ns
