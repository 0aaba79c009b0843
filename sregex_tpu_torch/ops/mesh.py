"""The device mesh: one process driving the scan kernels over several
devices, the counterpart of the JAX package's jax.sharding.Mesh and
shard_map.

A Mesh is an ordered list of torch devices along one axis ("data").  A
mesh-aware scan cuts the prep's block rows into ``size`` equal ranges:
block rows [i*B/n, (i+1)*B/n) go to shard i, which launches the tier's
own kernel on its device's current stream.  The per-chunk planes come
back in global chunk order on the lead device (the mesh's first), so the
summaries and host folds need no mesh-awareness, as in the JAX package.

Every mesh takes one route: a prep made for it holds each shard's blocks
on that shard's device (ShardedBlocks, placed once at prep time), the
tables are copied to each device once (replica), and each shard's
planes are copied to the lead device in shard order.  A device-to-device
``copy_`` orders the two devices' current streams, so the lead device
never reads planes a shard's stream has not written.  A mesh that lists
one device several times (the tests' eight CPU shards, four shards of
one card) is a virtual mesh: there the copies are no-ops and a replica
is the tables themselves.  Nothing here substitutes a mesh for a
missing device: a CUDA device that torch cannot see raises.
"""

import copy
import math

import torch


def _check_device(dev):
    """``dev`` as a torch.device a shard may run on, or raise."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("mesh device %s was asked for, but "
                               "torch.cuda.is_available() is False" % dev)
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError("mesh device %s is missing: torch sees %d "
                               "CUDA devices" % (dev,
                                                 torch.cuda.device_count()))
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError("unsupported mesh device %r" % str(dev))
    return dev


class Mesh:
    """An ordered list of devices along one axis.  ``size`` and
    ``shape[axis]`` stand where the JAX package reads mesh.devices.size
    and mesh.shape[axis]; ``lead`` is the first device, where results
    are gathered."""

    def __init__(self, devices, axis="data"):
        devs = tuple(_check_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs
        self.axis = axis
        self.size = len(devs)
        self.shape = {axis: self.size}
        self.lead = devs[0]

    def __repr__(self):
        return "Mesh(%s, axis=%r)" % ([str(d) for d in self.devices],
                                      self.axis)


def make_mesh(devices=None, axis="data"):
    """A 1-D mesh over ``devices`` (every CUDA device by default).  A
    device listed more than once makes a virtual mesh:
    make_mesh([torch.device("cpu")] * 8) is the tests' eight-shard CPU
    mesh.  Raises where no device is given and torch sees no card."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: torch sees no CUDA device; pass "
                               "devices= (a virtual mesh lists one device "
                               "several times)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices, axis)


def b_multiple(mesh, base=1):
    """The block-count multiple a prep for ``mesh`` needs."""
    return base if mesh is None else math.lcm(int(base), mesh.size)


class ShardedBlocks:
    """A prep's packed words for a mesh: ``parts[i]`` holds shard
    i's block rows on its device.  ``shape`` is the whole prep's,
    ``device`` the lead device's."""

    def __init__(self, parts):
        self.parts = list(parts)
        p0 = self.parts[0]
        self.shape = torch.Size([sum(p.shape[0] for p in self.parts),
                                 *p0.shape[1:]])
        self.device = p0.device
        self.dtype = p0.dtype


def fits(prepared, mesh):
    """Whether a prep tuple (data, C, K, J, B) can be scanned over
    ``mesh`` as it is: its block count divides over the mesh, and
    ShardedBlocks only on a mesh of the same devices (a single tensor on
    a mesh is cut, and copied to the shards of other devices, at each
    scan)."""
    data, B = prepared[0], prepared[4]
    if isinstance(data, ShardedBlocks):
        return mesh is not None \
            and [p.device for p in data.parts] == list(mesh.devices)
    return mesh is None or B % mesh.size == 0


def shard_rows(B, mesh):
    """Block rows a shard of ``mesh`` takes of B."""
    if B % mesh.size:
        raise ValueError("%d block rows do not divide over a mesh of %d "
                         "shards (prepare with b_multiple=%d)"
                         % (B, mesh.size, mesh.size))
    return B // mesh.size


def shard_blocks(data, mesh):
    """The per-shard block ranges of ``data`` (int32 [B, ...] or
    ShardedBlocks), each on its shard's device: the prep's parts, or
    row ranges of one tensor (copied to the shards of other devices)."""
    if isinstance(data, ShardedBlocks):
        if [p.device for p in data.parts] != list(mesh.devices):
            raise ValueError("the prep was placed for another mesh")
        return data.parts
    rows = shard_rows(data.shape[0], mesh)
    return [data[i * rows:(i + 1) * rows].to(d, non_blocking=True)
            for i, d in enumerate(mesh.devices)]


def _moved(value, device):
    """A tensor, or a namedtuple of tensors and plain values, on
    ``device``; anything else as it is."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return value._replace(**{
            f: v.to(device) for f, v in zip(value._fields, value)
            if isinstance(v, torch.Tensor)})
    return value


def replica(obj, device):
    """``obj`` (a tables object) with its tensors on ``device``: obj
    itself where it lies there, else a shallow copy with every tensor
    (and every tensor of a namedtuple, such as the two-code or 16-bit
    table) copied to ``device``, made at the first call and kept on obj.
    The copy's plain attributes are obj's as they were then: a caller
    passes what can change (the warmup) explicitly.  Tensors an object
    builds lazily on its own device (core._hot_map, prep._class_lut) are
    built on the replica for a shard, so the replica is the one cache of
    an object's tensors on another device."""
    device = _check_device(device)
    if _check_device(obj.device) == device:
        return obj
    reps = obj.__dict__.setdefault("_replicas", {})
    rep = reps.get(str(device))
    if rep is None:
        rep = copy.copy(obj)
        attrs = rep.__dict__
        attrs.pop("_replicas", None)
        for k, v in list(attrs.items()):
            attrs[k] = _moved(v, device)
        rep.device = device
        reps[str(device)] = rep
    return rep


def shard_planes(tables, data, state0, j0, mesh, launch):
    """Run a scan kernel over ``mesh``: launch(t, data, state0, j0)
    launches one kernel with tables ``t`` on tensors of one device and
    returns its (phi, fm, swarm).  mesh None: one launch over
    everything.  Otherwise shard i scans its block rows with the tables'
    replica on its device; returns the three planes int32 [B, G, 8, 128]
    on state0's device in global chunk order."""
    if mesh is None:
        return launch(tables, data, state0, j0)
    parts = shard_blocks(data, mesh)
    rows = shard_rows(state0.shape[0], mesh)
    # every shard's launch is enqueued before any plane is gathered
    got = [launch(replica(tables, dev), part,
                  state0[i * rows:(i + 1) * rows].to(dev, non_blocking=True),
                  j0[i * rows:(i + 1) * rows].to(dev, non_blocking=True))
           for i, (dev, part) in enumerate(zip(mesh.devices, parts))]
    lead = state0.device
    return tuple(torch.cat([g[k].to(lead, non_blocking=True) for g in got])
                 for k in range(3))
