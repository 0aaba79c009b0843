"""Plain reference of the regex-redux configuration: where one of the
nine variants (pattern i = variant i) ends a match.  Every alternative
of every variant is 8 letters long, each a letter or a class of
letters, so a match ends with its last byte at column t exactly when
the 8 bytes up to t read one alternative.  Plain torch comparisons,
written from the patterns; nothing of the program."""

import re

import torch

VARIANTS = [
    "agggtaaa|tttaccct",
    "[cgt]gggtaaa|tttaccc[acg]",
    "a[act]ggtaaa|tttacc[agt]t",
    "ag[act]gtaaa|tttac[agt]ct",
    "agg[act]taaa|ttta[agt]cct",
    "aggg[acg]aaa|ttt[cgt]ccct",
    "agggt[cgt]aa|tt[acg]accct",
    "agggta[cgt]a|t[acg]taccct",
    "agggtaa[cgt]|[acg]ttaccct",
]
MAXLEN = 8


def _positions(alt):
    """The letters allowed at each of an alternative's 8 places."""
    return [set(m[1]) if m[1] else {m[2]}
            for m in re.finditer(r"\[([a-z]+)\]|([a-z])", alt)]


ALTERNATIVES = [_positions(a) for v in VARIANTS for a in v.split("|")]
assert all(len(a) == MAXLEN for a in ALTERNATIVES)


def end_mask(rows, lead):
    """bool [R, W - lead]: column i is set where a variant ends a match
    with its last byte at rows[:, lead + i], reading only that row."""
    nrows, width = rows.shape
    out = torch.zeros(nrows, width - lead, dtype=torch.bool,
                      device=rows.device)
    t0 = max(lead, MAXLEN - 1)
    if t0 >= width:
        return out
    planes = {}

    def plane(letters, i):
        key = ("".join(sorted(letters)), i)
        if key not in planes:
            # the i-th byte of the 8-byte window that ends at each column
            col = rows[:, t0 - 7 + i:width - 7 + i]
            hit = torch.zeros_like(col, dtype=torch.bool)
            for c in letters:
                hit |= col == ord(c)
            planes[key] = hit
        return planes[key]

    hit = torch.zeros(nrows, width - t0, dtype=torch.bool,
                      device=rows.device)
    for alt in ALTERNATIVES:
        one = plane(alt[0], 0).clone()
        for i in range(1, MAXLEN):
            one &= plane(alt[i], i)
        hit |= one
    out[:, t0 - lead:] = hit
    return out


def ids_ending(data, end):
    """The ids of the variants that end a match at boundary ``end``."""
    w = bytes(data[max(0, end - MAXLEN):end]).decode("latin-1")
    return {i for i, v in enumerate(VARIANTS) if re.fullmatch(v, w)}
