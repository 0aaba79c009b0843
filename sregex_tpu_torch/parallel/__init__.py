"""The multi-device layers of the port.

One process over a device mesh: ops/mesh.py's Mesh (make_mesh), which
Scanner(mesh=) and the ops' ``mesh=`` arguments shard over, and
sharded_scan_bytes, the enumerative scan with its shard summaries
composed on the lead device.  Several processes: distributed (the
torch.distributed bootstrap and this process's slice of a corpus) and
multihost (a count or first-match scan of a corpus of which each process
holds one slice, over its local mesh, the host folds' inputs moved by
collectives).  dryrun.dryrun_multichip checks all of it on tiny corpora.
"""

from ..ops.mesh import Mesh, make_mesh
from . import distributed, multihost
from .sharded_scan import sharded_scan_bytes

__all__ = ["Mesh", "make_mesh", "sharded_scan_bytes", "distributed",
           "multihost"]
