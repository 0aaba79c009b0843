"""The benchmark of sregex_tpu_torch: one command runs one cell once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the repository root names the cells, configurations
and metrics; everything that belongs to one of them sits in a file of
its own here, found by its name (configs/, traffic/, metrics/,
controls/, gen/).  The plain references, the work counts of the
rooflines, the traffic generators and the comparison that decides
``correct`` live here too, and import nothing of the program."""
