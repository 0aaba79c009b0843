"""The least time a scan kernel could take, from the corpus and the
machine, not from the program's layout, and a kernel's share of it.

Peaks: one NVIDIA H100 SXM at its full 700 W, NVIDIA's data sheet:
3.35 TB/s of HBM, 67 T 32-bit operations a second outside the tensor
cores.  A DFA scan of n bytes over a machine of S states and C byte
classes has to read each byte once at least as its class code,
ceil(log2 C) bits, the transition table once (S x C entries of
ceil(log2 S) bits), and write, for each chunk of the call's chunk
length, its exit state and a 32-bit count or first-match word; and it
makes one step, one 32-bit operation at least, a byte.  The bound is
the larger of the bytes over the bandwidth and the steps over the
operation rate."""

import math

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12


def code_bits(n):
    """Bits of a code that tells n values apart (at least 1)."""
    return max(1, math.ceil(math.log2(n)))


def scan_work(nbytes, states, classes, chunk_len):
    """(bytes moved, operations) of one DFA scan over nbytes."""
    corpus = nbytes * code_bits(classes) / 8
    table = states * classes * code_bits(states) / 8
    chunks = -(-nbytes // chunk_len)
    planes = chunks * (code_bits(states) + 32) / 8
    return corpus + table + planes, nbytes


def bound_seconds(nbytes, states, classes, chunk_len):
    """(seconds, "bytes" or "operations"): the least time of the scan,
    and which peak bounds it."""
    moved, ops = scan_work(nbytes, states, classes, chunk_len)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_share(run, name):
    """Percent of the roofline that the traced kernels whose name holds
    ``name`` reach: the bound of one query's scan over those kernels'
    device time per query of the traced window.  None where the trace
    holds no such kernel."""
    if run.trace is None or not run.shards:
        return None
    spent = sum(sec for op, sec in run.trace.seconds_by_name().items()
                if name in op)
    if spent <= 0:
        return None
    config = run.cell.config
    bound, _ = bound_seconds(run.shard_bytes, config["machine"]["states"],
                             config["machine"]["classes"],
                             config["chunk_len"])
    return 100.0 * bound / (spent / len(run.shards))
