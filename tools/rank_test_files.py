"""Rank test files by the worker time a pytest run spent in them.

Reads the JUnit file of a run (pytest --junitxml=PATH) and prints, for
each test file, the seconds its cases took (setup, call and teardown,
as pytest records them), its passes, skips and failures, largest first,
then the totals.  Under ``-p xdist --dist loadfile`` a file is the unit
a worker takes, so a file's seconds are what it holds one worker.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q \\
        -m 'not slow' -p xdist -n 6 --dist loadfile -p no:randomly \\
        --junitxml=$TMPDIR/port.xml
    python3 tools/rank_test_files.py $TMPDIR/port.xml [--cases N]

``--cases N`` also lists the N slowest cases.
"""

import argparse
import collections
import xml.etree.ElementTree as ET


def rank(path):
    """(per-file [seconds, passed, skipped, failed], [(seconds, case)])
    from the JUnit file at ``path``."""
    files = collections.defaultdict(lambda: [0.0, 0, 0, 0])
    cases = []
    for tc in ET.parse(path).getroot().iter("testcase"):
        name = tc.get("classname", "").split(".")[-1]
        t = float(tc.get("time", 0))
        row = files[name]
        row[0] += t
        if tc.find("skipped") is not None:
            row[2] += 1
        elif tc.find("failure") is not None or tc.find("error") is not None:
            row[3] += 1
        else:
            row[1] += 1
        cases.append((t, "%s::%s" % (name, tc.get("name"))))
    return files, cases


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit")
    ap.add_argument("--cases", type=int, default=0)
    args = ap.parse_args()
    files, cases = rank(args.junit)
    print("%-34s %9s %6s %6s %6s" % ("file", "seconds", "passed", "skipped",
                                     "failed"))
    for name, (t, p, s, f) in sorted(files.items(), key=lambda x: -x[1][0]):
        print("%-34s %9.1f %6d %6d %6d" % (name, t, p, s, f))
    tot = [sum(r[i] for r in files.values()) for i in range(4)]
    print("%-34s %9.1f %6d %6d %6d" % ("total", *tot))
    for t, case in sorted(cases, reverse=True)[:args.cases]:
        print("%9.1f  %s" % (t, case))


if __name__ == "__main__":
    main()
