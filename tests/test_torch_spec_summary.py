"""The summary kernel's fold (csrc/spec_summary.cu) as a numpy model,
against the torch summary it replaces on the card (spec_scan._summarize
and _pack_planes, which CPU tensors keep and which
tests/test_torch_spec_scan.py holds against the JAX package).

The kernel validates a span of chunks a block and leaves a record a
block (its first bad chunk, its fm sum mod 2**32 and last firing chunk
below that and below C); the last block folds the records in chunk
order.  summary_model repeats that at spans 1, 7 and 1024 over the edge
cases chip_smoke.py's summary phase runs on the card (every chunk
valid; the first miss at chunk 0, at 1023 and 1024 across a block edge,
at the last chunk; C below the planes' chunks; a bad tail; the escape
state; scan mode with fm set; a prefix count past 2**31) and random
planes.  CPU tensors never launch the kernel: spec_summary_launches
stays 0.  Every quantity is an integer; the comparisons are exact.
"""

import numpy as np
import pytest
import torch

from chip_smoke import SUMMARY_CASES, summary_case
from sregex_tpu_torch import build_dfa, compile_regex, parse_multi
from sregex_tpu_torch.native import NativeDfa
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.layout import GROUPS

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHAPE = (1, GROUPS, 8, 128)
SPANS = (1, 7, 1024)
NONE = 2 ** 31 - 1


def summary_model(phi, fm, swarm, state0, C, bad_tail, COUNT, ESC, span):
    """The kernel's summary, int32 [10], by its two levels: per block of
    ``span`` chunks the first bad chunk, then the fm sum and last firing
    chunk below it and below C; then the fold of the records up to the
    block of the first bad chunk of all (every record where none)."""
    phi, fm, swarm = (np.asarray(a, np.int64).reshape(-1)
                      for a in (phi, fm, swarm))
    Cp = phi.size
    entry0 = int(np.asarray(state0).reshape(-1)[0])
    entries = np.concatenate([[entry0], phi[:-1]])
    idx = np.arange(Cp)
    ok = swarm == entries
    if ESC is not None:
        ok &= phi != ESC
    if not COUNT:
        ok &= fm == 0
    ok = (ok | (idx >= C)) & (idx != bad_tail)

    nb = -(-Cp // span)
    pad = nb * span - Cp
    bidx = np.pad(idx, (0, pad), constant_values=NONE).reshape(nb, span)
    bok = np.pad(ok, (0, pad), constant_values=True).reshape(nb, span)
    bfm = np.pad(fm, (0, pad)).reshape(nb, span)
    bad = np.where(bok, NONE, bidx).min(1)
    live = bidx < np.minimum(bad, C)[:, None]
    sums = np.where(live, bfm, 0).sum(1) & 0xFFFFFFFF
    fires = np.where(live & (bfm != 0), bidx, -1).max(1)

    gbad = int(bad.min())
    upto = nb - 1 if gbad == NONE else gbad // span
    total = int(sums[:upto + 1].sum()) & 0xFFFFFFFF
    last = int(fires[:upto + 1].max())
    fb = 0 if gbad == NONE else gbad
    return np.array([gbad == NONE, fb, entries[fb], phi[fb], swarm[fb],
                     fm[fb], phi[C - 1], total - (total >> 31 << 32), last,
                     entries[max(last, 0)]], dtype=np.int64)


def pack_model(phi, fm, swarm, wide):
    """The repair planes the kernel writes: int32 [3, ...] wide, else
    uint8 [4, ...] (phi, fm & 0xFF, swarm, fm >> 8 & 0xFF)."""
    if wide:
        return np.stack([phi, fm, swarm])
    return np.stack([phi, fm, swarm, fm >> 8]).astype(np.uint8)


def _case(name, seed):
    return summary_case(name, np.random.default_rng(seed), SHAPE)


CASES = [(name, i) for i, name in enumerate(SUMMARY_CASES)]
CASES += [("random", 100 + i) for i in range(6)]


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("name,seed", CASES)
def test_model_fold_equals_torch_summary(name, seed, span):
    arrays, (C, bad_tail, COUNT, ESC) = _case(name, seed)
    tensors = [torch.from_numpy(a) for a in arrays]
    before = tscan.spec_summary_launches
    want, _ = tscan._summarize(*tensors, C, bad_tail, COUNT, ESC)
    got = summary_model(*arrays, C, bad_tail, COUNT, ESC, span)
    assert np.array_equal(got, want.numpy())
    for wide in (False, True):
        _, packed = tscan._summary_and_planes(tensors[:3], tensors[3], C,
                                              bad_tail, COUNT, wide, ESC)
        assert np.array_equal(packed.numpy(),
                              pack_model(*arrays[:3], wide))
    assert tscan.spec_summary_launches == before


def test_cases_reach_what_they_name():
    """Each edge case makes the summary it is named for, so the spans
    above fold across the edges meant."""
    got = {}
    for name, seed in CASES[:len(SUMMARY_CASES)]:
        arrays, args = _case(name, seed)
        got[name] = summary_model(*arrays, *args, 1024), args
    Cp = int(np.prod(SHAPE))
    assert got["all_valid"][0][0] == 1 and got["all_valid"][0][1] == 0
    for name, at in (("bad_at_0", 0), ("bad_at_1023", 1023),
                     ("bad_at_1024", 1024), ("bad_at_last", Cp - 1)):
        assert tuple(got[name][0][:2]) == (0, at)
    assert got["short_C"][0][0] == 1 and got["short_C"][1][0] < Cp
    C = got["bad_tail"][1][0]
    assert tuple(got["bad_tail"][0][:2]) == (0, C - 1)
    assert got["esc"][1][3] is not None
    assert tuple(got["esc"][0][:2]) == (0, Cp // 3)
    assert got["scan_fm"][0][1] == Cp // 2 + 3 and not got["scan_fm"][1][2]
    arrays, _ = _case("wrap", SUMMARY_CASES.index("wrap"))
    assert int(arrays[1].astype(np.int64).sum()) >= 2 ** 31
    assert got["wrap"][0][7] != int(arrays[1].astype(np.int64).sum())


def test_cpu_scan_keeps_the_torch_summary():
    """A CPU count through the wide tier takes the torch ops: no summary
    launch, and the count is the native engine's."""
    ast, _ = parse_multi([b"agggtaaa", b"tttaccct", b"cgt"])
    dfa = build_dfa(compile_regex(ast))
    tables = tscan.SpecTablesWide(dfa, CPU)
    rng = np.random.default_rng(5)
    data = rng.choice(np.frombuffer(b"acgt", np.uint8), 300_000).tobytes()
    before = (tscan.spec_summary_launches, tscan.spec_scan_launches)
    state, count = tscan.spec_count_bytes(tables, data)
    want, wstate = NativeDfa(dfa).count(data, 0)
    assert (count, state) == (want, wstate)
    assert (tscan.spec_summary_launches, tscan.spec_scan_launches) == before


def test_spec_summary_refuses_cpu_tensors():
    arrays, (C, bad_tail, COUNT, ESC) = _case("all_valid", 0)
    tensors = [torch.from_numpy(a) for a in arrays]
    before = tscan.spec_summary_launches
    with pytest.raises(ValueError):
        tscan.spec_summary(tensors[:3], tensors[3], C, bad_tail, COUNT,
                           True, ESC)
    assert tscan.spec_summary_launches == before


@pytest.mark.parametrize("wide", [False, True])
def test_pack_alone_equals_the_summarys_pack(wide):
    """summary=False (the pipeline's pack-only call, the kernel's launch
    with no summary) gives no summary and the same pack as a summary
    call, in either format."""
    arrays, (C, bad_tail, COUNT, ESC) = _case("random", 7)
    tensors = [torch.from_numpy(a) for a in arrays]
    args = (tensors[:3], tensors[3], C, bad_tail, COUNT, wide, ESC)
    summ, alone = tscan._summary_and_planes(*args, summary=False)
    assert summ is None
    assert alone.dtype == (torch.int32 if wide else torch.uint8)
    assert torch.equal(alone, tscan._summary_and_planes(*args)[1])
    assert np.array_equal(alone.numpy(), pack_model(*arrays[:3], wide))
