"""The plain reference against a brute-force scan on small seeded
corpora, the block reader, the judge and the control."""

import re

import numpy as np
import pytest
import torch

from portbench import harness, reference

REDUX = harness.load_module(harness.HERE / "configs" / "regex-redux.py")
VARIANTS = [re.compile(v.encode()) for v in REDUX.VARIANTS]


def brute_ends(data):
    """Every boundary where a variant ends a match, by Python's re (every
    alternative is 8 letters long)."""
    return {i for i in range(8, len(data) + 1)
            if any(v.fullmatch(data, i - 8, i) for v in VARIANTS)}


def corpus(seed, n):
    rng = np.random.default_rng(seed)
    data = bytearray(rng.choice(np.frombuffer(b"acgtBN", np.uint8), n))
    alts = [b"agggtaaa", b"tttaccct", b"cgggtaaa", b"tttacccg",
            b"atggtaaa", b"agggtaat", b"tgtaccct"]
    for at in rng.integers(0, n - 8, 40):
        data[at:at + 8] = alts[at % len(alts)]
    return bytes(data)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_end_mask_against_brute_force(seed):
    data = corpus(seed, 3001 + seed)
    want = brute_ends(data)
    rows = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    for lead in (0, 1, 7, 13):
        got = REDUX.end_mask(rows.view(1, -1), lead)[0]
        assert {lead + int(i) + 1 for i in torch.nonzero(got)} == \
            {e for e in want if e - 1 >= lead}
    # rows read alone: a match lies inside one row
    width = 100
    cut = len(data) // width * width
    got = REDUX.end_mask(rows[:cut].view(-1, width), 0)
    local = {e for e in brute_ends(data[:cut])
             if (e - 1) // width == (e - 8) // width}
    assert {int(r) * width + int(c) + 1
            for r, c in torch.nonzero(got)} == local


def test_answers_in_blocks(monkeypatch):
    data = corpus(7, 40960)
    want = sorted(brute_ends(data))
    for block in (4096, 6144, 1 << 20):
        monkeypatch.setattr(reference, "BLOCK", block)
        a = reference.answers(REDUX, data, "cpu")
        assert (a.first, a.count) == (want[0], len(want))
        assert a.ids == REDUX.ids_ending(data, want[0]) and a.ids
        local = reference.answers(REDUX, data, "cpu", chunk=2048)
        assert local.count <= a.count


def test_ids_ending():
    data = b"xxagggtaacgagggtaaa tttacccg"
    assert REDUX.ids_ending(data, 10) == {8}
    assert REDUX.ids_ending(data, 19) == {0}
    assert REDUX.ids_ending(data, 18) == set()
    assert REDUX.ids_ending(data, len(data)) == {1}


def test_judge():
    ref = reference.Answer(first=100, count=7, ids={2, 5})
    none = reference.Answer(first=None, count=0)
    judge = reference.judge
    assert judge("count", 7, ref, 1000) == (False, 0)
    assert judge("count", 9, ref, 1000) == (True, 2)
    assert judge("scan", (5, 100), ref, 1000) == (False, 0)
    assert judge("scan", (3, 100), ref, 1000) == (True, 0)
    assert judge("scan", (2, 98), ref, 1000) == (True, 2)
    assert judge("scan", None, ref, 1000) == (True, 1000)
    assert judge("scan", (2, 100), none, 1000) == (True, 1000)
    assert judge("scan", None, none, 1000) == (False, 0)
    assert judge("count", reference.FAILED, ref, 1000) == (True, 1000)
    assert reference.as_result("scan", ref) == (2, 100)
    assert reference.as_result("scan", none) is None
    assert reference.as_result("count", ref) == 7


def test_control_breaks_its_guarantee():
    local = harness.load_module(harness.HERE / "controls" / "chunk_local.py")
    # a variant across the boundary at 2048 is lost read chunk by chunk
    dna = bytearray(b"acct" * 1024)
    dna[2044:2052] = b"agggtaaa"
    dna = bytes(dna)
    assert reference.answers(REDUX, dna, "cpu").count == 1
    assert local.answer(REDUX, dna, "cpu", 2048).count == 0
