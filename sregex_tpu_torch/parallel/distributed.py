"""Multi-process bootstrap: the torch.distributed process group, this
process's mesh, and its slice of a corpus.

Counterpart of the JAX package's parallel/distributed.py (which wraps
jax.distributed).  Each process drives its own local devices as one
mesh (ops/mesh.py); what crosses processes is host data for the host
folds (parallel/multihost.py), so the default backend is gloo, which
serves CPU tensors between processes on one machine or several, and
on one card as well as on many.

Usage in each process:

    from sregex_tpu_torch.parallel import distributed as dist
    dist.initialize()                    # COORDINATOR_ADDRESS etc.
    mesh = dist.global_mesh()            # this process's devices
    lo, hi = dist.host_slice(len(corpus))
    # multihost.count_multihost(tables, corpus[lo:hi], mesh, K, n)
"""

import os

import torch.distributed as tdist

from ..ops.mesh import make_mesh


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend=None, **kw):
    """init_process_group from the arguments or the environment
    (COORDINATOR_ADDRESS, "host:port" or an init URL such as
    tcp://host:port or file:///path; NUM_PROCESSES; PROCESS_ID), with
    ``backend`` gloo unless named.  A no-op where the group exists
    already or one process is asked for (no coordinator, or
    NUM_PROCESSES 1); a group that was asked for and fails to form
    raises.  ``kw`` goes to init_process_group (e.g. timeout)."""
    if tdist.is_initialized():
        return
    ca = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    nproc = num_processes or os.environ.get("NUM_PROCESSES")
    pid = process_id if process_id is not None \
        else os.environ.get("PROCESS_ID")
    if not ca or nproc is None or int(nproc) <= 1:
        return
    if pid is None:
        raise ValueError("a %s-process group needs PROCESS_ID" % nproc)
    url = ca if "://" in ca else "tcp://" + ca
    tdist.init_process_group(backend or "gloo", init_method=url,
                             world_size=int(nproc), rank=int(pid), **kw)


def process_index():
    """This process's rank (0 without a process group)."""
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count():
    """The process group's size (1 without one)."""
    return tdist.get_world_size() if tdist.is_initialized() else 1


def global_mesh(axis="data", devices=None):
    """The mesh this process drives: ``devices``, else every CUDA device
    it sees (ops/mesh.make_mesh).  The processes' meshes together cover
    the job; each scans its own slice of the corpus on its own."""
    return make_mesh(devices, axis)


def host_slice(nbytes, chunk=1):
    """This process's contiguous [lo, hi) byte range of a corpus split
    evenly, in ``chunk``-byte units, across the process group."""
    p = process_index()
    nproc = process_count()
    units = -(-nbytes // chunk)
    per = -(-units // nproc)
    lo = min(p * per * chunk, nbytes)
    hi = min((p + 1) * per * chunk, nbytes)
    return lo, hi
