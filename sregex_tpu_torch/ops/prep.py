"""Corpus preprocessing: class-map, warmup windows, sub-byte packing
and the [B, Jw, G, 8, 128] stream tiling.

Two paths with bit-identical output, as in the JAX package
(its ops/pallas_scan.py::_prepare and ops/prep.py):

  - host prep (_prepare): numpy, then one upload of the packed words;
  - device prep (prepare_on_device): the raw bytes go to the device
    and torch does the rest there.

Device prep keeps the whole-corpus intermediates at one byte per
corpus byte.  Class ids are looked up slice by slice (the int32 index
a lookup needs would be 4 bytes per corpus byte over the whole
corpus), the windows are a strided view of the class array, and the
packing runs a few blocks at a time, so the peak beyond the output is
the class array plus one slice's temporaries.
"""

import os
import warnings

import numpy as np
import torch

from .layout import GROUPS, TILE, effective_chunk
from .mesh import ShardedBlocks, b_multiple as _mesh_multiple, replica

# corpora at least this large use device prep (the host pass wins below)
DEVICE_PREP_MIN = 16 << 20
_MAP_SLICE = 1 << 26        # bytes class-mapped per lookup
_PACK_STREAMS = 1 << 17     # chunk streams packed per step


def _host_u8(data):
    """A uint8 CPU tensor over bytes or an ndarray, without a copy.
    The tensor may share a read-only buffer; nothing here writes to it."""
    arr = data if isinstance(data, np.ndarray) else np.frombuffer(
        data, dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def _pack_words(arr, bits):
    """numpy [..., CPW] class ids -> int32 [...] words, class k in bits
    [bits*k, bits*(k+1)) (the top field of 8-bit packing wraps into the
    sign bit, as in the JAX prep)."""
    if bits == 4:
        nib = arr[..., 0::2] | (arr[..., 1::2] << 4)
        return np.ascontiguousarray(nib).view("<u4")[..., 0] \
            .astype(np.int32)
    words = arr[..., 0].astype(np.int32).copy()
    for k in range(1, arr.shape[-1]):
        words |= arr[..., k].astype(np.int32) << (bits * k)
    return words


def _prepare(tables, data_np, chunk_len, b_multiple=1,
             prev_tail_cls=None):
    """Host prep.  Returns (packed int32 [B, J//CPW, G, 8, 128] on
    tables.device, C, K, J, B) where C is the live chunk count, K the
    chunk length and J = W + K, all in bytes.

    prev_tail_cls: optional uint8 [W] class ids filling chunk 0's
    warmup window (zeros otherwise)."""
    from numpy.lib.stride_tricks import sliding_window_view

    n = len(data_np)
    CPW = tables.cpw
    bpu = getattr(tables, "bpu", 1)    # bytes per kernel unit
    K = effective_chunk(tables, chunk_len)
    W = tables.warmup
    G = GROUPS
    C = max(1, -(-n // K))
    B = -(-C // (G * TILE))
    B = -(-B // b_multiple) * b_multiple
    Cp = B * G * TILE
    J = W + K

    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np

    from ..native import get_lib, _u8p, _i32p
    lib = get_lib() if bpu == 1 else None
    if tables.bits == 4 and prev_tail_cls is None and lib is not None \
            and hasattr(lib, "sre_pack_prepare"):
        # native single-pass prep (the JAX package's host path uses
        # the same routine)
        packed = np.empty((B, J // CPW, G, 8, 128), dtype=np.int32)
        lib.sre_pack_prepare(_u8p(raw), n, _u8p(tables.class_map),
                             K, W, G, Cp, _i32p(packed.reshape(-1)))
    else:
        cls = np.frombuffer(
            raw.tobytes().translate(tables.class_map.tobytes()),
            dtype=np.uint8)
        padded = np.zeros(W + Cp * K, dtype=np.uint8)
        if prev_tail_cls is not None:
            padded[:W] = prev_tail_cls
        padded[W:W + n] = cls
        if bpu == 2:
            # pair ids: K and W are even, so pairs never straddle a
            # window; windows and packing then run in pair units
            cb = tables.byte_ncls
            padded = (padded[0::2].astype(np.int16) * cb
                      + padded[1::2]).astype(np.uint8)
        Ku, Ju = K // bpu, J // bpu
        win = sliding_window_view(padded, Ju)[::Ku][:Cp]   # [Cp, Ju]
        arr = np.ascontiguousarray(win).reshape(B, G, TILE,
                                                Ju // CPW, CPW)
        words = _pack_words(arr, tables.bits)
        packed = np.ascontiguousarray(words.transpose(0, 3, 1, 2))
        packed = packed.reshape(B, Ju // CPW, G, 8, 128)
    return torch.from_numpy(packed).to(tables.device), C, K, J, B


def _class_lut(tables):
    """tables.class_map as a uint8 tensor on tables.device, uploaded at
    the first call and kept on the tables object (a copy made by
    with_warmup shares it: the class map is the same; a mesh shard reads
    its replica's, ops/mesh.replica)."""
    lut = getattr(tables, "_class_lut_dev", None)
    if lut is None:
        lut = torch.from_numpy(tables.class_map.astype(np.uint8)) \
            .to(tables.device)
        tables._class_lut_dev = lut
    return lut


def _class_ids(tables, data, n, length, W, tail_cls):
    """uint8 [W + length] on tables.device: chunk 0's W warmup classes,
    the class ids of the n corpus bytes, then class 0 (the padding,
    whatever class byte 0 maps to).  tail_cls: None (class 0, as the
    padding), a uint8 numpy [W], or a uint8 tensor [W] (the pipeline
    stages it through pinned memory, so nothing here waits on the
    device)."""
    device = tables.device
    out = torch.zeros(W + length, dtype=torch.uint8, device=device)
    if tail_cls is not None:
        out[:W] = (tail_cls.to(device, non_blocking=True)
                   if isinstance(tail_cls, torch.Tensor)
                   else torch.from_numpy(tail_cls).to(device))
    lut = _class_lut(tables)
    for lo in range(0, n, _MAP_SLICE):
        hi = min(n, lo + _MAP_SLICE)
        # a uint8 index would be a boolean mask: index with int32
        raw = data[lo:hi].to(device)
        out[W + lo:W + hi] = lut[raw.to(torch.int32)]
    return out


def _device_pack(cls, *, K, J, B, CPW, BITS):
    """cls: uint8 class (or pair) ids [W + Cp*K] in kernel units, with
    window c = cls[c*K : c*K + J].  Returns the packed int32
    [B, J//CPW, G, 8, 128] tiling, bit-identical to the host prep."""
    G = GROUPS
    Jw = J // CPW
    win = cls.as_strided((B * G * TILE, J), (K, 1))       # [Cp, J] view
    out = torch.empty((B, Jw, G, 8, 128), dtype=torch.int32,
                      device=cls.device)
    step = max(1, _PACK_STREAMS // (G * TILE))
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        w = win[b0 * G * TILE:b1 * G * TILE]
        words = w[:, 0::CPW].to(torch.int32)
        for k in range(1, CPW):
            words |= w[:, k::CPW].to(torch.int32) << (BITS * k)
        # stream tiling: chunk c = ((b*G + g)*TILE + t)
        out[b0:b1] = words.view(b1 - b0, G, TILE, Jw) \
            .permute(0, 3, 1, 2).reshape(b1 - b0, Jw, G, 8, 128)
    return out


def _device_pack_pair(cls, cb, *, K, J, B, CPW, BITS):
    """Pair-unit device prep: combine adjacent class ids into pair ids
    (K and W are even, so pairs never straddle a window), then window
    and pack in pair units."""
    pair = cls[0::2] * cb + cls[1::2]   # < cb*cb <= 256: no wrap
    return _device_pack(pair, K=K // 2, J=J // 2, B=B, CPW=CPW,
                        BITS=BITS)


def prepare_on_device(tables, data, chunk_len, b_multiple=1,
                      prev_tail_cls=None):
    """Device-side analogue of _prepare: the same (packed, C, K, J, B)
    tuple and bit-identical words, but only raw bytes cross to the
    device.  ``data`` may be bytes, a uint8 ndarray or a uint8 tensor
    (already on the device: then nothing crosses).  ``prev_tail_cls``
    as for _prepare, or, below 2 GiB of padded corpus (where the device
    prep runs; the pipeline cuts its segments to stay there), a uint8
    tensor on the device."""
    n = len(data)
    K = effective_chunk(tables, chunk_len)
    W = tables.warmup
    G = GROUPS
    C = max(1, -(-n // K))
    B = -(-C // (G * TILE))
    B = -(-B // b_multiple) * b_multiple
    L = B * G * TILE * K
    if L >= 2 ** 31:
        # the JAX package's device prep masks with an int32 iota and
        # falls back to host prep past 2 GiB of padded corpus; this
        # one takes the same path, so both packages agree on it
        if isinstance(data, torch.Tensor):
            data = data.cpu().numpy()
        return _prepare(tables, data, chunk_len, b_multiple=b_multiple,
                        prev_tail_cls=prev_tail_cls)
    if not isinstance(data, torch.Tensor):
        data = _host_u8(data)
    tail = prev_tail_cls
    if tail is not None and not isinstance(tail, torch.Tensor):
        tail = np.asarray(tail, dtype=np.uint8)
    cls = _class_ids(tables, data, n, L, W, tail)
    return _pack(tables, cls, K, B), C, K, W + K, B


def _pack(tables, cls, K, B):
    """The packed tiling of the class ids ``cls`` (window c =
    cls[c*K : c*K + W + K]) in the tables' units."""
    J = tables.warmup + K
    if getattr(tables, "bpu", 1) == 2:
        return _device_pack_pair(cls, tables.byte_ncls, K=K, J=J, B=B,
                                 CPW=tables.cpw, BITS=tables.bits)
    return _device_pack(cls, K=K, J=J, B=B, CPW=tables.cpw,
                        BITS=tables.bits)


def shard_spans(tables, n, chunk_len, mesh, b_multiple=1):
    """The mesh prep's geometry for an n-byte corpus over ``mesh``:
    (C, K, B, spans), spans[i] = (lo, hi) the corpus bytes shard i
    class-maps.  Shard i holds chunks [i*Cs, (i+1)*Cs), Cs = B/size *
    G * TILE, so its windows read bytes from W before its first chunk
    (shard 0 reads the caller's warmup classes there instead); a shard
    past the corpus reads none."""
    K = effective_chunk(tables, chunk_len)
    W = tables.warmup
    C = max(1, -(-n // K))
    B = -(-C // (GROUPS * TILE))
    bm = _mesh_multiple(mesh, b_multiple)
    B = -(-B // bm) * bm
    span = B // mesh.size * GROUPS * TILE * K
    spans = []
    for i in range(mesh.size):
        lo = 0 if i == 0 else min(n, i * span - W)
        spans.append((lo, max(lo, min(n, (i + 1) * span))))
    return C, K, B, spans


def pack_shards(tables, segs, K, B, mesh, prev_tail_cls=None):
    """The mesh prep from each shard's bytes ``segs[i]`` (uint8 tensors,
    shard_spans' ranges, on any device; moved to the shard's):
    ShardedBlocks whose part i equals block rows [i*B/n, (i+1)*B/n) of
    the whole corpus's prep, bit for bit."""
    W = tables.warmup
    rows = B // mesh.size
    length = rows * GROUPS * TILE * K
    parts = []
    for i, (dev, seg) in enumerate(zip(mesh.devices, segs)):
        t = replica(tables, dev)
        seg = seg.to(dev, non_blocking=True)
        if i == 0:
            cls = _class_ids(t, seg, len(seg), length, W, prev_tail_cls)
        else:
            # the W bytes before the shard's first chunk are corpus bytes
            cls = _class_ids(t, seg, len(seg), W + length, 0, None)
        parts.append(_pack(t, cls, K, rows))
    return ShardedBlocks(parts)


def prepare_shards(tables, data, chunk_len, mesh, b_multiple=1,
                   prev_tail_cls=None):
    """prepare_on_device for a mesh: each shard's bytes go to its device
    and are prepared there.  Returns (ShardedBlocks, C, K, J, B)."""
    n = len(data)
    C, K, B, spans = shard_spans(tables, n, chunk_len, mesh, b_multiple)
    if not isinstance(data, torch.Tensor):
        data = _host_u8(data)
    tail = prev_tail_cls
    if tail is not None and not isinstance(tail, torch.Tensor):
        tail = np.asarray(tail, dtype=np.uint8)
    packed = pack_shards(tables, [data[lo:hi] for lo, hi in spans], K, B,
                         mesh, tail)
    return packed, C, K, tables.warmup + K, B


def prepare_auto(tables, data, chunk_len, b_multiple=1,
                 prev_tail_cls=None, mesh=None):
    """Device prep for large corpora and for tensor input, host prep
    for small host corpora.  SREGEX_DEVICE_PREP=1 forces device prep,
    =0 host prep (the JAX package's knob).  ``mesh`` takes
    prepare_shards (the block count divides over it)."""
    if mesh is not None:
        return prepare_shards(tables, data, chunk_len, mesh, b_multiple,
                              prev_tail_cls)
    knob = os.environ.get("SREGEX_DEVICE_PREP")
    use_dev = (len(data) >= DEVICE_PREP_MIN if knob is None
               else knob == "1")
    if use_dev or isinstance(data, torch.Tensor):
        return prepare_on_device(tables, data, chunk_len,
                                 b_multiple=b_multiple,
                                 prev_tail_cls=prev_tail_cls)
    return _prepare(tables, data, chunk_len, b_multiple=b_multiple,
                    prev_tail_cls=prev_tail_cls)
