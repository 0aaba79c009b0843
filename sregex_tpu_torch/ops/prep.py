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


def _class_ids(tables, data, n, length, tail_cls):
    """uint8 [W + length] on tables.device: chunk 0's warmup classes,
    the class ids of the n corpus bytes, then class 0 (the padding,
    whatever class byte 0 maps to)."""
    device = tables.device
    W = len(tail_cls)
    out = torch.zeros(W + length, dtype=torch.uint8, device=device)
    out[:W] = torch.from_numpy(tail_cls).to(device)
    lut = torch.from_numpy(tables.class_map.astype(np.uint8)).to(device)
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
    (already on the device: then nothing crosses)."""
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
    tail = (np.zeros(W, dtype=np.uint8) if prev_tail_cls is None
            else np.asarray(prev_tail_cls, dtype=np.uint8))
    cls = _class_ids(tables, data, n, L, tail)
    if getattr(tables, "bpu", 1) == 2:
        dev = _device_pack_pair(cls, tables.byte_ncls, K=K, J=W + K,
                                B=B, CPW=tables.cpw, BITS=tables.bits)
    else:
        dev = _device_pack(cls, K=K, J=W + K, B=B, CPW=tables.cpw,
                           BITS=tables.bits)
    return dev, C, K, W + K, B


def prepare_auto(tables, data, chunk_len, b_multiple=1,
                 prev_tail_cls=None):
    """Device prep for large corpora and for tensor input, host prep
    for small host corpora.  SREGEX_DEVICE_PREP=1 forces device prep,
    =0 host prep (the JAX package's knob)."""
    knob = os.environ.get("SREGEX_DEVICE_PREP")
    use_dev = (len(data) >= DEVICE_PREP_MIN if knob is None
               else knob == "1")
    if use_dev or isinstance(data, torch.Tensor):
        return prepare_on_device(tables, data, chunk_len,
                                 b_multiple=b_multiple,
                                 prev_tail_cls=prev_tail_cls)
    return _prepare(tables, data, chunk_len, b_multiple=b_multiple,
                    prev_tail_cls=prev_tail_cls)
