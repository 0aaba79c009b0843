"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds sregex_tpu_torch.  Needs as
many CUDA cards as the cell asks for: without them it exits with 3 and
prints no result.  The last line of standard output is the result (one
JSON object); the last lines of standard error are the numbers that
decided ``correct``, each beside its limit.  --trace 1 reports the
cell's per-layer metrics from a torch.profiler trace of the window,
--trace 0 its end-to-end metrics."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's kernels build under build/sregex_tpu_torch in the
# checkout; CUDA's JIT cache goes beside them, at a fixed path
CUDA_CACHE = ROOT / "build" / "portbench" / "cuda"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, system=None):
    """Exit code of one run; ``system`` as harness.run takes it."""
    args = parse(argv)
    os.environ["CUDA_CACHE_PATH"] = str(CUDA_CACHE)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    chips = harness.load_cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("%s needs %d CUDA card(s); torch sees %s" % (
            args.workload, chips, torch.cuda.device_count()
            if torch.cuda.is_available() else "none"), file=sys.stderr)
        return 3
    result, error = harness.run(
        args.workload, args.seed % 2 ** 64, args.seconds, args.trace,
        t_start=T_START, system=system)
    if error:
        print("a query raised:\n" + error, file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print("loaded in the run's process: %s" % ", ".join(found),
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print("check %s %s limit %s" % (name, c["value"], c["limit"]),
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
