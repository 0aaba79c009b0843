"""Carry the JAX package's device state over to the port.

The fused tables are this system's weights: a JAX tables object holds
them as [8, 128] (narrow) or [R, 8, 128] (wide, pair, big, affine)
int32 arrays, each 128-entry row broadcast over the 8 sublanes.  The
port holds the same entries as one flat [R*128] int32 tensor.  These
functions take the JAX arrays as numpy (the caller does
``np.asarray(x).copy()``; core_tables_from_jax takes the JAX object and
does it itself), so nothing here imports jax.
"""

import numpy as np
import torch

from .native import NativeDfa
from .ops.affine import SpecTablesAffine, relay_table
from .ops.big import SpecTablesBig
from .ops.core import CoreTables
from .ops.layout import max_chunk_bytes
from .ops.pair import SpecTablesPair
from .ops.phi import PhiTables, PhiTablesBig
from .ops.spec_scan import SpecTables, SpecTablesWide, resolve_device
from .ops.tdfa_scan import TdfaSpecTables

# the JAX tables class (its name) -> the port's
_KINDS = {c.__name__: c for c in (SpecTables, SpecTablesWide,
                                  SpecTablesPair, SpecTablesBig,
                                  SpecTablesAffine)}


def _flat_rows(a):
    """[8, 128] or [R, 8, 128] sublane-broadcast rows -> flat [R*128]."""
    a = np.asarray(a, dtype=np.int32)
    rows = a[None] if a.ndim == 2 else a
    if rows.ndim != 3 or rows.shape[1:] != (8, 128):
        raise ValueError("fused table must be [8,128] or [R,8,128], got %s"
                         % (a.shape,))
    if not (rows == rows[:, :1]).all():
        raise ValueError("fused table rows are not sublane-broadcast")
    return np.ascontiguousarray(rows[:, 0]).reshape(-1)


def spec_tables_from_jax(arrays, dfa, device):
    """Build the port's tables from a JAX tables object's arrays.

    ``arrays``: a mapping with ``kind``, the JAX tables class name
    (SpecTables, SpecTablesWide, SpecTablesPair, SpecTablesBig or
    SpecTablesAffine), which picks the port's class of the same name;
    ``fused_vec`` ([8,128]) or ``fused_rows`` ([R,8,128]); ``cpw``,
    ``bits``, ``warmup`` and ``rows``; for pair tables ``byte_ncls``;
    for affine tables ``pieces``, ``bp_premult``, ``off`` and ``perm``
    (None or the renumbering).  ``dfa`` is the Dfa both were built
    from."""
    kind = arrays["kind"]
    cls = _KINDS.get(kind)
    if cls is None:
        raise ValueError("no port tables for the JAX class %r" % kind)
    fused_rows = arrays.get("fused_rows")
    fused = _flat_rows(fused_rows if fused_rows is not None
                       else arrays["fused_vec"])
    t = cls.__new__(cls)
    t.nstates = dfa.nstates
    t.cpw = int(arrays["cpw"])
    t.bits = int(arrays["bits"])
    t.warmup = int(arrays["warmup"])
    t.rows = int(arrays.get("rows", 1))
    if fused.size != t.rows * 128:
        raise ValueError("fused table holds %d entries, rows=%d"
                         % (fused.size, t.rows))
    pair = cls is SpecTablesPair
    if pair:
        t.bpu = 2
        t.byte_ncls = int(arrays["byte_ncls"])
        t.ncls = t.byte_ncls * t.byte_ncls
        t.wide = t.rows > 1
    else:
        t.ncls = dfa.nclasses
    if cls is SpecTablesAffine:
        t.pieces = int(arrays["pieces"])
        t.bp_premult = tuple(int(b) for b in arrays["bp_premult"])
        t.off = int(arrays["off"])
        perm = arrays.get("perm")
        t.perm = None if perm is None else np.asarray(perm, np.int64)
        if t.perm is not None:
            t.inv = np.argsort(t.perm)
    t.max_chunk = max_chunk_bytes(t.cpw, bpu=2 if pair else 1)
    t._finish(dfa, fused, device)
    if cls is SpecTablesAffine:
        t.bp = torch.tensor(t.bp_premult, dtype=torch.int32,
                            device=t.device)
        t.relaid = relay_table(fused, t.bp_premult, t.ncls, t.bits, t.off,
                               t.device)
    return t


def core_tables_from_jax(jax_ct, device):
    """The port's CoreTables carrying a JAX CoreTables across: the same
    full and core machines (``jax_ct.dfa`` and ``jax_ct.core``, which the
    port's engines read as they read its own Dfa), the same hot set
    (``hot2full``, ``full2core``, ``H``), the JAX inner tables through
    spec_tables_from_jax, and ``esc_premult``, which must equal H times
    the inner alphabet as the port derives it."""
    inner = jax_ct.inner
    arrays = {k: getattr(inner, k) for k in ("cpw", "bits", "warmup",
                                             "rows", "byte_ncls")
              if hasattr(inner, k)}
    arrays["kind"] = type(inner).__name__
    for k in ("fused_vec", "fused_rows"):
        v = getattr(inner, k, None)
        if v is not None:
            arrays[k] = np.asarray(v).copy()
    t = CoreTables.__new__(CoreTables)
    t._adopt(jax_ct.dfa, NativeDfa(jax_ct.dfa), resolve_device(device),
             spec_tables_from_jax(arrays, jax_ct.core, device), jax_ct.core,
             np.asarray(jax_ct.hot2full, dtype=np.int64).copy(),
             np.asarray(jax_ct.full2core, dtype=np.int32).copy())
    if t.H != int(jax_ct.H) or t.esc_premult != int(jax_ct.esc_premult):
        raise ValueError("core of %d states, esc %d; JAX %s, %s"
                         % (t.H, t.esc_premult, jax_ct.H,
                            jax_ct.esc_premult))
    return t


# what a JAX TdfaSpecTables and the port's must agree on
_TDFA_FIELDS = ("nstates", "nregs", "ntags", "ncls", "code_bits", "rows",
                "bits", "cpw", "warmup", "seed_premult", "dead_premult")


def tdfa_tables_from_jax(arrays, prog, device):
    """The port's TdfaSpecTables carrying a JAX TdfaSpecTables's code
    planes.

    ``arrays``: ``t_next`` and ``t_cmeta`` ([rows, 8, 128]), ``t_regsrc``
    and ``t_csrc`` ([P, rows, 8, 128]), ``tags`` and the scalar fields
    of _TDFA_FIELDS.  The port builds its own tagged DFA from ``prog``
    (the host folds walk it; the BFS numbers its states as the JAX
    package's does), checks that the scalar fields agree, and takes the
    JAX planes, flattened to [rows*128], in place of its own."""
    t = TdfaSpecTables(prog, device, tags=tuple(arrays["tags"]))
    for key in _TDFA_FIELDS:
        if int(arrays[key]) != getattr(t, key):
            raise ValueError("%s: JAX %s, port %s"
                             % (key, arrays[key], getattr(t, key)))

    def dev(a):
        return torch.from_numpy(a).to(t.device)

    t.t_next = dev(_flat_rows(arrays["t_next"]))
    t.t_cmeta = dev(_flat_rows(arrays["t_cmeta"]))
    t.t_regsrc = dev(np.stack([_flat_rows(p) for p in arrays["t_regsrc"]]))
    t.t_csrc = dev(np.stack([_flat_rows(p) for p in arrays["t_csrc"]]))
    return t


# what a JAX phi tables object and the port's must agree on, per layout
_PHI_FIELDS = {"PhiTables": ("nstates", "ncls", "rows", "bits", "nseg"),
               "PhiTablesBig": ("nstates", "ncls", "rows", "bits", "SB")}


def phi_tables_from_jax(arrays, dfa, device):
    """The port's PhiTables or PhiTablesBig carrying a JAX phi tables
    object's fused table.

    ``arrays``: ``kind``, the JAX class name (PhiTables or PhiTablesBig),
    which picks the port's class of the same name; ``fused_rows``
    ([rows, 8, 128]); and the scalar fields ``nstates``, ``ncls``,
    ``rows``, ``bits`` and ``nseg`` (PhiTables) or ``SB``
    (PhiTablesBig).  The port builds its own tables from ``dfa``, checks
    that those fields agree, and takes the JAX table, flattened to
    [rows*128], in place of its own."""
    kind = arrays["kind"]
    cls = {"PhiTables": PhiTables, "PhiTablesBig": PhiTablesBig}.get(kind)
    if cls is None:
        raise ValueError("no port phi tables for the JAX class %r" % kind)
    t = cls(dfa, device)
    for key in _PHI_FIELDS[kind]:
        if int(arrays[key]) != getattr(t, key):
            raise ValueError("%s: JAX %s, port %s"
                             % (key, arrays[key], getattr(t, key)))
    fused = _flat_rows(arrays["fused_rows"])
    if fused.size != t.rows * 128:
        raise ValueError("fused table holds %d entries, rows=%d"
                         % (fused.size, t.rows))
    t.fused = torch.from_numpy(fused).to(t.device)
    return t


def prepared_from_jax(np_packed, C, K, J, B, device):
    """A JAX prepared corpus (packed int32 [B, J//CPW, G, 8, 128] as
    numpy, plus its C, K, J, B) as the port's prepared tuple."""
    packed = np.ascontiguousarray(np_packed, dtype=np.int32)
    if packed.ndim != 5 or packed.shape[0] != B:
        raise ValueError("packed corpus must be [B, Jw, G, 8, 128] with "
                         "B=%d, got %s" % (B, packed.shape))
    return torch.from_numpy(packed).to(torch.device(device)), C, K, J, B
