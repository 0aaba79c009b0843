"""The CUDA scan kernel against its plain torch version, on the card.

Marked ``cuda``: these skip where torch sees no card.  On a machine
with one, run ``python -m pytest tests/test_torch_cuda.py -m cuda``.
The tolerance is exact equality of all three planes."""

import numpy as np
import pytest
import torch

from sregex_tpu_torch.ops import spec_scan as tscan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("bits,rows,count,W", [
    (4, 1, True, 32), (4, 1, False, 128), (3, 1, False, 40),
    (8, 1, True, 16), (8, 3, False, 16), (8, 98, True, 16)])
def test_kernel_equals_plain_version(cuda, bits, rows, count, W):
    rng = np.random.default_rng(bits * 100 + rows)
    cpw = {3: 10, 4: 8, 8: 4}[bits]
    B, G, Jw = 2, 8, (W + 480) // cpw     # 480: whole loop iterations
    words = rng.integers(0, 1 << 32, (B, Jw, G, 8, 128), dtype=np.uint64)
    data = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    ncls = min(1 << bits, 16)
    S = rows * 128 // ncls
    nxt = rng.integers(0, S, rows * 128) * ncls
    match = rng.integers(0, 2, rows * 128) << 20
    table = torch.from_numpy((nxt | match).astype(np.int32))
    s0 = torch.from_numpy(
        (rng.integers(0, S, (B, G, 8, 128)) * ncls).astype(np.int32))
    j0 = torch.from_numpy(
        rng.integers(0, W + 1, (B, G, 8, 128)).astype(np.int32))
    args = [t.to(cuda) for t in (data, s0, j0, table)]
    kw = dict(W=W, CPW=cpw, BITS=bits, COUNT=count)
    got = tscan.spec_scan(*args, **kw)
    torch.cuda.synchronize()
    want = tscan.spec_scan_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
