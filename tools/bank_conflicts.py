"""Count the shared-memory wavefronts a warp's table lookups need on the
main paths' corpora: a model on the host, not a device measurement.

    python3 tools/bank_conflicts.py [MB]

Walks the first MB MB (default 20; whole warps of 32 chunks) of
chip_smoke.py's headline corpus through the headline's two-code table
(csrc/pair_scan.cu) and its fused table (the one-lookup kernel,
csrc/spec_scan.cu), and the same slice of the big phase's corpus
through the 500-keyword dictionary's 16-bit table (csrc/big_scan.cu)
and its wide-kernel layout (one int32 a step, the layout of
csrc/spec_scan.cu with the table in shared memory), every chunk
entered at state 0 after its warmup, as the speculative streams are.
A warp is 32 neighbouring chunks (lanes of one sublane row).  At each
main-loop step it takes the 4-byte words the 32 lanes read; a
shared-memory load needs as many wavefronts as the most distinct words
any one of the 32 banks holds (lanes reading one word share it).
Prints one JSON line per table: the mean and the largest wavefronts a
warp-load, and the mean distinct words a load.
Runs on the CPU (numpy and the port's host engines).
"""

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import sregex_tpu_torch  # noqa: E402

K = 2048                 # chunk bytes


def wavefronts(words):
    """[warps, 32] word addresses -> per-warp wavefronts and distinct
    words."""
    w = np.sort(words, axis=1)
    first = np.ones_like(w, dtype=bool)
    first[:, 1:] = w[:, 1:] != w[:, :-1]
    per_bank = np.zeros((w.shape[0], 32), np.int64)
    rows = np.repeat(np.arange(w.shape[0]), 32).reshape(w.shape)
    np.add.at(per_bank, (rows[first], w[first] % 32), 1)
    return per_bank.max(axis=1), first.sum(axis=1)


def chunks(dfa, corpus, warmup):
    """Class ids [streams, K] of each chunk and the state (id) every
    stream enters its main loop in, after warmup bytes from state 0."""
    cls = dfa.class_map[np.frombuffer(corpus, np.uint8)].astype(np.int64)
    n = (cls.size - warmup) // (32 * K) * 32
    main = cls[warmup:warmup + n * K].reshape(n, K)
    s = np.zeros(n, np.int64)
    trans = np.asarray(dfa.trans, np.int64)
    for j in range(warmup):
        s = trans[s, cls[np.arange(n) * K + j]]
    return main, s


def report(name, addrs):
    """addrs: [steps] of [streams] word addresses."""
    waves, distinct = [], []
    for a in addrs:
        wv, d = wavefronts(a.reshape(-1, 32))
        waves.append(wv)
        distinct.append(d)
    waves, distinct = np.concatenate(waves), np.concatenate(distinct)
    print(json.dumps({"table": name, "warp_loads": int(waves.size),
                      "mean_wavefronts": float(waves.mean()),
                      "max_wavefronts": int(waves.max()),
                      "mean_distinct_words": float(distinct.mean())}),
          flush=True)


def headline(mb):
    t = sregex_tpu_torch.compile_pattern(cs.HEADLINE, device="cpu")._spec
    dfa = t.dfa
    main, s = chunks(dfa, cs.headline_corpus(mb + 5)[:mb << 20], t.warmup)
    trans = np.asarray(dfa.trans, np.int64)
    ncls = dfa.nclasses
    rowmap = t.pair.rowmap.numpy().astype(np.int64)
    one, two = [], []
    for j in range(0, K, 2):
        c0, c1 = main[:, j], main[:, j + 1]
        # the pair table: row offset (bytes) / 4 + the code pair
        two.append(rowmap[s * ncls] // 4 + (c0 | c1 << t.bits))
        one.append(s * ncls + c0)
        s1 = trans[s, c0]
        one.append(s1 * ncls + c1)
        s = trans[s1, c1]
    report("narrow two-code (pair_scan.cu)", two)
    report("narrow one-lookup (spec_scan.cu)", one)


def big(mb):
    words = cs.dictionary(500)
    t = sregex_tpu_torch.compile_pattern(words, device="cpu")._spec
    dfa = t.dfa
    main, s = chunks(dfa, cs.multi_corpus(mb, words), t.warmup)
    trans = np.asarray(dfa.trans, np.int64)
    ncls = dfa.nclasses
    b16, b32 = [], []
    for j in range(K):
        c = main[:, j]
        b16.append((s * ncls + c) // 2)      # 16-bit entries
        b32.append(s * ncls + c)             # int32 entries
        s = trans[s, c]
    report("big 16-bit (big_scan.cu)", b16)
    report("big as int32 in shared memory (spec_scan.cu layout)", b32)


def main():
    mb = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    headline(mb)
    big(mb)


if __name__ == "__main__":
    main()
