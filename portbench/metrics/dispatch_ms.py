"""dispatch_ms: the host's work before the card has the scan kernel, in
milliseconds: the mean over the untraced window's queries (spans.py) of
the time from the call's root span's start to the end of its last
sregex.launch span (the tier choice, the prep lookup, the entry planes,
the kernel launches)."""

from portbench.spans import plain_queries


def read(run):
    queries = plain_queries(run)
    if not queries:
        return None
    ends = [(max(s.end_ns for s in kids if s.name == "sregex.launch")
             - root.start_ns)
            for root, kids in queries
            if any(s.name == "sregex.launch" for s in kids)]
    return sum(ends) / len(ends) / 1e6 if ends else None
