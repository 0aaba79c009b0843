"""Measure the headline's dfa_scan_gbps and the 500-keyword dictionary's
count_gbps for several checkouts of the repository, in turns, on one
card.

    python3 tools/compare_rates.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a checkout (for example the parent commit
unpacked with git archive into a gitignored directory, and "." for the
tree); give them in the order to run, e.g. parent . . parent.  Each runs
in a process of its own that imports that checkout's sregex_tpu_torch
and chip_smoke.py, builds its kernels, and measures as chip_smoke.py's
headline and big phases do: the first-match scan of the headline
pattern over SREGEX_BENCH_MB MB (default 1920) through
spec_scan_bytes, and Scanner.count of the dictionary over
SREGEX_BENCH_BIG_MB MB, each on a corpus prepared on the card, min of
5 reps, every rep checked against the native engine.  Prints the
card's name and power limit, then one JSON line per run: the checkout,
both rates and the launches of each kernel counter the checkout has.
Needs a CUDA card.
"""

import json
import subprocess
import sys
from pathlib import Path

RUN = r'''
import json, os, sys
root, phases = sys.argv[1], sys.argv[2].split(",")
sys.path.insert(0, root)
import torch
import chip_smoke as cs
import sregex_tpu_torch
from sregex_tpu_torch import build_dfa, compile_regex, parse
from sregex_tpu_torch.ops import _build, big
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import spec_scan as scan
from sregex_tpu_torch.ops.prep import prepare_on_device

_build.load()
counters = [(m, k) for m in (scan, big, tcore) for k in dir(m)
            if k.endswith("_launches") and isinstance(getattr(m, k), int)]
out = {"checkout": root}


def launches():
    return {k: getattr(m, k) for m, k in counters}


if "headline" in phases:
    mb = cs.mb_env("SREGEX_BENCH_MB")
    corpus = cs.headline_corpus(mb)
    dfa = build_dfa(compile_regex(parse(cs.HEADLINE)[0]))
    t = scan.SpecTables(dfa, "cuda")
    native = sregex_tpu_torch.compile_pattern(cs.HEADLINE, device=None)
    first, _ = native._native.scan_first(corpus, 0)
    prepared = prepare_on_device(t, corpus, 2048)

    def check_first(r):
        if r[1] != first:
            raise AssertionError("offset %r != native %r" % (r[1], first))

    cs.reset_launches()
    dt = cs.min_rep_seconds(
        lambda: scan.spec_scan_bytes(t, corpus, prepared=prepared),
        check_first)
    out["dfa_scan_gbps"] = len(corpus) / dt / 1e9
    out["headline_launches"] = launches()
    del prepared, corpus

if "big" in phases or "fused" in phases:
    words = cs.dictionary(500)
    bsc = sregex_tpu_torch.compile_pattern(words)
    bmb = cs.mb_env("SREGEX_BENCH_BIG_MB")
    bcorpus = cs.multi_corpus(bmb, words)
    bexp = cs.native_count(bsc, bcorpus)

    def check_big(c):
        if c != bexp:
            raise AssertionError("big count %r != native %r" % (c, bexp))

if "big" in phases:
    bprep = bsc.prepare(bcorpus)
    check_big(bsc.count(bcorpus, prepared=bprep))
    cs.reset_launches()
    bdt = cs.min_rep_seconds(lambda: bsc.count(bcorpus, prepared=bprep),
                             check_big)
    out["big_count_gbps"] = len(bcorpus) / bdt / 1e9
    out["big_tier"] = bsc.stats().tier
    out["big_launches"] = launches()
    del bprep

if "fused" in phases:
    os.environ["SREGEX_FUSED"] = "1"
    fsc = sregex_tpu_torch.compile_pattern(words)
    fprep = fsc.prepare(bcorpus)
    check_big(fsc.count(bcorpus, prepared=fprep))
    cs.reset_launches()
    fdt = cs.min_rep_seconds(lambda: fsc.count(bcorpus, prepared=fprep),
                             check_big)
    out["fused_count_gbps"] = len(bcorpus) / fdt / 1e9
    out["fused_tier"] = fsc.stats().tier
    out["fused_launches"] = launches()
    fct, full = fsc._fusedct, fsc._spec
    inner = fct.inner
    ck = tcore.fused_chunk(inner, full)
    cdata, C, K, _, B1 = fprep.for_tables(inner, ck)
    fdata = fprep.for_tables(full, ck)[0]
    n = len(bcorpus)
    Cfull = C - 1 if C * K > n and n - (C - 1) * K != K else C
    out["fused_device_ms"] = cs.time_gpu(lambda: tcore._fused_count(
        cdata, fdata, inner, full, fct._h2f_dev, Cfull,
        fct.to_core_premult(0), 0, CAP=tcore._fused_cap(B1),
        ESC=fct.esc_premult), 20)
    out["n_esc"] = fct.last_escapes[0]
print(json.dumps(out), flush=True)
'''


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    args, phases = sys.argv[1:], "headline,big,fused"
    if args[:1] == ["--only"]:
        phases, args = args[1], args[2:]
    for root in args:
        root = str(Path(root).resolve())
        r = subprocess.run([sys.executable, "-c", RUN, root, phases],
                           cwd=root, capture_output=True, text=True)
        lines = r.stdout.strip().splitlines()
        if r.returncode or not lines:
            raise SystemExit("%s failed (%d):\n%s%s" % (
                root, r.returncode, r.stdout[-3000:], r.stderr[-3000:]))
        print(lines[-1], flush=True)


if __name__ == "__main__":
    main()
