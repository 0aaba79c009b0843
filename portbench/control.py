"""Run one cell with its configuration's control in the program's
place, and print the result line as run.py does.  The control is the
plain reference with one of the configuration's guarantees broken
(controls/<control>.py); its run has to come out as not correct.  The
benchmark's own runs never run it.

    python3 portbench/control.py --workload <cell> --seed <n> --seconds <s>

Each shard's control answer is worked out once in set-up, on the card,
and every query of the window returns its shard's."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness, reference  # noqa: E402
from portbench.run import main  # noqa: E402


def control_system(cell, shards, device):
    config = cell.config
    ctl = harness.load_module(harness.HERE / "controls"
                              / (config["control"] + ".py"))
    ref = harness.load_module(harness.HERE / "configs"
                              / (config["name"] + ".py"))
    call = cell.traffic["call"]
    res = [reference.as_result(call, ctl.answer(ref, s, device,
                                                config["chunk_len"]))
           for s in shards]
    return harness.System(lambda k: res[k])


if __name__ == "__main__":
    sys.exit(main(system=control_system))
