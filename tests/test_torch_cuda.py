"""The CUDA scan kernels against their plain torch versions, on the card.

Marked ``cuda``: these skip where torch sees no card.  On a machine
with one, run ``python -m pytest tests/test_torch_cuda.py -m cuda``.
The tolerance is exact equality of every output plane."""

import numpy as np
import pytest
import torch

from sregex_tpu_torch.ops import affine as taff
from sregex_tpu_torch.ops import big as tbig
from sregex_tpu_torch.ops import phi as tphi
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops import tdfa_scan as ttdfa

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


@pytest.mark.parametrize("bits,rows,ncls,count", [
    (4, 600, 16, True), (4, 1024, 9, False), (8, 821, 27, True),
    (8, 1024, 200, False)])
def test_big_kernel_equals_plain_version(cuda, bits, rows, ncls, count):
    """Tables past the shared-memory cap, classes below ncls (every
    index inside the table)."""
    rng = np.random.default_rng(bits * 1000 + rows)
    cpw = {4: 8, 8: 4}[bits]
    B, G, W = 2, 8, 32
    Jw = (W + 480) // cpw
    cls = rng.integers(0, ncls, (B, Jw, G, 8, 128, cpw), dtype=np.int64)
    words = np.zeros(cls.shape[:-1], np.int64)
    for k in range(cpw):
        words |= cls[..., k] << (bits * k)
    data = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    S = rows * 128 // ncls
    table = torch.from_numpy((rng.integers(0, S, rows * 128) * ncls
                              | rng.integers(0, 2, rows * 128) << 20)
                             .astype(np.int32))
    assert table.numel() > tscan.SMEM_TABLE_MAX
    s0 = torch.from_numpy(
        (rng.integers(0, S, (B, G, 8, 128)) * ncls).astype(np.int32))
    j0 = torch.from_numpy(
        rng.integers(0, W + 1, (B, G, 8, 128)).astype(np.int32))
    args = [t.to(cuda) for t in (data, s0, j0, table)]
    kw = dict(W=W, CPW=cpw, BITS=bits, COUNT=count)
    before = tbig.big_scan_launches
    got = tbig.big_scan(*args, **kw)
    torch.cuda.synchronize()
    assert tbig.big_scan_launches == before + 1
    want = tbig.big_scan_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _spec_launches():
    """Launches of the speculative scan's shared-memory kernels: the
    one-lookup kernel and the two-code kernel (narrow 3- and 4-bit
    tables)."""
    return tscan.spec_scan_launches + tscan.pair_scan_launches


def _scan_case(rng, bits, rows, ncls, W, *, in_range=False,
               odd_entry=False, frozen=False, j0_odd=False, raw=False,
               B=2, G=8, K=480):
    """Random words (classes up to 2**bits, or below ncls with
    ``in_range``), a random table of rows*128 entries over S = rows*128
    // ncls states with match fields 0-2, valid entry states and
    freezes j0 in [0, W].  ``odd_entry``: a third of the entry states
    arbitrary (negative, past the table, off the ncls grid); ``frozen``:
    half the streams frozen through the whole warmup; ``j0_odd``: every
    freeze odd (inside a code pair); ``raw``: next fields off the ncls
    grid.  Returns (numpy arrays, the CPU tensors, S)."""
    cpw = {3: 10, 4: 8, 8: 4}[bits]
    K = K // (2 * cpw) * (2 * cpw)
    shape = (B, (W + K) // cpw, G, 8, 128)
    cls = rng.integers(0, ncls if in_range else 1 << bits, shape + (cpw,))
    words = np.zeros(shape, np.int64)
    for k in range(cpw):
        words |= cls[..., k] << (bits * k)
    S = rows * 128 // ncls
    nxt = rng.integers(0, 1 << 9, rows * 128) if raw \
        else rng.integers(0, S, rows * 128) * ncls
    table = (nxt | rng.integers(0, 3, rows * 128) << 20).astype(np.int32)
    planes = (B, G, 8, 128)
    s0 = (rng.integers(0, S, planes) * ncls).astype(np.int32)
    j0 = rng.integers(0, W + 1, planes).astype(np.int32)
    if j0_odd:
        j0 |= 1
    if odd_entry:
        pick = rng.random(planes) < 1 / 3
        s0[pick] = rng.integers(-300, S * ncls + 3000, int(pick.sum()))
    if frozen:
        j0[rng.random(planes) < 0.5] = W
    arrays = (words.astype(np.uint32).view(np.int32), s0, j0, table)
    return [torch.from_numpy(a) for a in arrays], S


@pytest.mark.parametrize("bits,ncls,W,opts", [
    (4, 16, 32, {}), (4, 4, 32, dict(j0_odd=True)),
    (4, 9, 8, dict(odd_entry=True, frozen=True)), (4, 16, 0, {}),
    (4, 5, 32, dict(raw=True, odd_entry=True)), (3, 8, 40, {}),
    (3, 5, 10, dict(odd_entry=True, frozen=True)),
    (3, 6, 40, dict(j0_odd=True))])
def test_pair_kernel_equals_plain_version(cuda, bits, ncls, W, opts):
    """The two-code kernel (csrc/pair_scan.cu) against spec_scan_ref, COUNT
    and scan: classes past ncls, freezes inside a code pair, one and no
    warm word, entry states off the table's rows, some frozen through
    the whole warmup, next fields off the ncls grid."""
    rng = np.random.default_rng(bits * 100 + ncls * 10 + W)
    args, S = _scan_case(rng, bits, 1, ncls, W, **opts)
    pt = tscan.pair_table(args[3].numpy(), ncls, S, bits, cuda)
    assert pt is not None
    args = [t.to(cuda) for t in args]
    cpw = {3: 10, 4: 8}[bits]
    for count in (True, False):
        kw = dict(W=W, CPW=cpw, BITS=bits, COUNT=count)
        before = (tscan.pair_scan_launches, tscan.spec_scan_launches)
        got = tscan.spec_scan(*args, pair=pt, **kw)
        torch.cuda.synchronize()
        assert (tscan.pair_scan_launches, tscan.spec_scan_launches) == \
            (before[0] + 1, before[1])
        for g, w in zip(got, tscan.spec_scan_ref(*args, **kw)):
            assert torch.equal(g, w), count


@pytest.mark.parametrize("bits,rows,ncls,opts", [
    (4, 600, 16, dict(in_range=True)), (4, 300, 9, {}),
    (8, 821, 27, {}), (8, 200, 200, dict(odd_entry=True)),
    (8, 64, 27, dict(odd_entry=True, frozen=True)),
    (8, 907, 128, dict(in_range=True)), (8, 908, 128, dict(in_range=True)),
    (4, 40, 5, dict(odd_entry=True))])
def test_big_smem_kernel_equals_plain_version(cuda, bits, rows, ncls, opts):
    """The 16-bit kernel (csrc/big_scan.cu) against big_scan_ref, COUNT and
    scan: classes past ncls (the wrap padding), entry states that are
    not rows, some frozen through the whole warmup, and a table just
    under (907 states of 128 classes) and just over (908: declined, the
    global-memory kernel serves) the shared-memory cap."""
    rng = np.random.default_rng(bits * 1000 + rows + ncls)
    args, S = _scan_case(rng, bits, rows, ncls, 32, B=1, **opts)
    t16 = tbig.big16_table(args[3].numpy(), ncls, S, bits, cuda)
    assert (t16 is None) == (rows == 908 and ncls == 128)
    args = [t.to(cuda) for t in args]
    cpw = {4: 8, 8: 4}[bits]
    for count in (True, False):
        kw = dict(W=32, CPW=cpw, BITS=bits, COUNT=count)
        before = (tbig.big_smem_launches, tbig.big_scan_launches)
        got = tbig.big_scan(*args, t16=t16, **kw)
        torch.cuda.synchronize()
        assert (tbig.big_smem_launches, tbig.big_scan_launches) == (
            (before[0], before[1] + 1) if t16 is None
            else (before[0] + 1, before[1]))
        for g, w in zip(got, tbig.big_scan_ref(*args, **kw)):
            assert torch.equal(g, w), count


def test_narrow_tier_takes_the_two_code_kernel_on_the_card(cuda):
    """The headline pattern counts and scans through the two-code
    kernel, equal to the native engine."""
    import sregex_tpu_torch
    pat = "(?:a|b)aa(?:aa|bb)cc(?:a|b)"
    sc = sregex_tpu_torch.compile_pattern(pat)
    host = sregex_tpu_torch.compile_pattern(pat, device=None)
    assert type(sc._spec).__name__ == "SpecTables"
    assert sc._spec.pair.rows == 11
    data = b"abccc" * (2 << 20) + b"xaaabbccb" + b"abccc" * 1000
    before = (tscan.pair_scan_launches, tscan.spec_scan_launches)
    assert sc.count(data) == host.count(data)
    assert sc.scan(data) == host.scan(data)
    assert tscan.pair_scan_launches == before[0] + 2
    assert tscan.spec_scan_launches == before[1]


@pytest.mark.parametrize("pieces,bits,count,W", [
    (1, 4, True, 32), (3, 4, False, 512), (17, 8, True, 16),
    (48, 8, False, 64), (48, 4, True, 32)])
def test_affine_kernel_equals_plain_version(cuda, pieces, bits, count, W):
    """Random tables of 1 to 48 pieces; classes run past the table."""
    rng = np.random.default_rng(pieces * 10 + bits)
    cpw = {4: 8, 8: 4}[bits]
    ncls = int(rng.integers(2, (1 << bits) + 1))
    S = pieces * 20
    off = S * ncls
    B, G = 2, 8
    Jw = (W + 480) // cpw
    words = rng.integers(0, 1 << 32, (B, Jw, G, 8, 128), dtype=np.uint64)
    data = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    bp = torch.from_numpy(np.sort(rng.choice(
        np.arange(1, S), pieces - 1, replace=False) * ncls).astype(np.int32))
    rows = -(-(pieces * ncls) // 128)
    table = torch.from_numpy(
        (rng.integers(0, 2 * off, rows * 128)
         | rng.integers(0, 2, rows * 128) << 28
         | rng.integers(0, 2, rows * 128) << 30).astype(np.int32))
    s0 = torch.from_numpy(
        (rng.integers(0, S, (B, G, 8, 128)) * ncls).astype(np.int32))
    j0 = torch.from_numpy(
        rng.integers(0, W + 1, (B, G, 8, 128)).astype(np.int32))
    args = [t.to(cuda) for t in (data, s0, j0, table, bp)]
    kw = dict(W=W, CPW=cpw, BITS=bits, NCLS=ncls, OFF=off, COUNT=count)
    rel = taff.relay_table(table.numpy(), bp.tolist(), ncls, bits, off, cuda)
    before = taff.affine_scan_launches
    got = taff.affine_scan(*args, relaid=rel, **kw)
    torch.cuda.synchronize()
    assert taff.affine_scan_launches == before + 1
    want = taff.affine_scan_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _affine_edge_case(rng, pieces, bits, edge, B=1, G=8, W=None, K=256):
    """Random affine inputs of P pieces, class codes up to 2**bits (past
    the table too).  ``edge``: "in" valid entry states and entries;
    "wrap" arbitrary int32 table entries and entry states (states out of
    range, relative steps that wrap), the breakpoints' neighbours and
    the int32 extremes among them."""
    cpw = {4: 8, 8: 4}[bits]
    W = W or 4 * cpw
    ncls = int(rng.integers(2, (1 << bits) + 1))
    S = pieces * int(rng.integers(3, 40))
    off = S * ncls
    Jw = (W + K) // cpw
    words = rng.integers(0, 1 << 32, (B, Jw, G, 8, 128), dtype=np.uint64)
    bp = np.sort(rng.choice(np.arange(1, S), pieces - 1, replace=False)
                 * ncls).astype(np.int32)
    rows = -(-(pieces * ncls) // 128)
    if edge == "wrap":
        table = rng.integers(-2 ** 31, 2 ** 31, rows * 128)
        s0 = rng.integers(-2 ** 31, 2 ** 31, (B, G, 8, 128))
        near = [-2 ** 31, 2 ** 31 - 1, -1, 0, off, off - 1]
        for b in bp.tolist():
            near += [b - 1, b, b + 1]
        s0.reshape(-1)[:len(near)] = near
    else:
        table = (rng.integers(0, 2 * off, rows * 128)
                 | rng.integers(0, 2, rows * 128) << 28
                 | rng.integers(0, 2, rows * 128) << 30)
        s0 = rng.integers(0, S, (B, G, 8, 128)) * ncls
    j0 = rng.integers(0, W + 1, (B, G, 8, 128))
    arrays = (words.astype(np.uint32).view(np.int32), s0.astype(np.int32),
              j0.astype(np.int32), table.astype(np.int32), bp)
    return ([torch.from_numpy(a) for a in arrays],
            dict(W=W, CPW=cpw, BITS=bits, NCLS=ncls, OFF=off))


@pytest.mark.parametrize("pieces", [1, 2, 3, 8, 9, 48])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("edge", ["in", "wrap"])
def test_affine_kernel_edge_families(cuda, pieces, bits, edge):
    """The templated kernel (P <= 8) and the generic one (past 8, or
    forced) equal the plain version on every class code, states out of
    range and int32 wrap, COUNT and scan."""
    rng = np.random.default_rng(pieces * 31 + bits + len(edge))
    args, kw = _affine_edge_case(rng, pieces, bits, edge)
    rel = taff.relay_table(args[3].numpy(), args[4].tolist(), kw["NCLS"],
                           bits, kw["OFF"], cuda)
    args = [t.to(cuda) for t in args]
    for count in (True, False):
        want = taff.affine_scan_ref(*args, COUNT=count, **kw)
        for generic in (False, True):
            got = taff.affine_scan(*args, COUNT=count, relaid=rel,
                                   generic=generic, **kw)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (count, generic)


def test_entry_points_run_on_the_card_by_default(cuda):
    import sregex_tpu_torch
    sc = sregex_tpu_torch.compile_pattern("a{400,499}b")
    assert sc.device.type == "cuda"
    assert type(sc._spec).__name__ == "SpecTablesAffine"
    sc.DEVICE_THRESHOLD = 1
    data = (b"x" + b"a" * 450 + b"b") * 3000
    before = taff.affine_scan_launches
    assert sc.count(data) == 3000
    assert taff.affine_scan_launches == before + 1


@pytest.mark.parametrize("bits,rows,code,R,T", [
    (4, 1, 4, 13, 13), (4, 3, 4, 5, 6), (8, 2, 8, 24, 24),
    (8, 1, 8, 14, 1), (4, 4, 16, 48, 48), (8, 16, 16, 48, 48)])
def test_tdfa_kernel_equals_plain_version(cuda, bits, rows, code, R, T):
    """Random code planes with R and T at the edges of their code width;
    classes run past the table.  The last case's 50 planes of 2048
    entries (400 KB) exceed shared memory: the global-memory variant."""
    rng = np.random.default_rng(bits * 100 + rows * 10 + code)
    cpw = 32 // bits
    B, G, W = 2, 8, 4 * cpw
    Jw = (W + 256) // cpw
    n = rows * 128
    ncls = 16 if bits == 4 else 40
    spp = 32 // code
    words = rng.integers(0, 1 << 32, (B, Jw, G, 8, 128), dtype=np.uint64)
    data = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    t_next = (rng.integers(0, max(1, n // ncls), n) * ncls).astype(np.int32)
    t_cmeta = np.where(rng.random(n) < 0.3,
                       1 | (rng.integers(0, 128, n) << 1),
                       rng.integers(0, 1 << 20, n) << 1).astype(np.int32)
    top = (1 << code) - 1

    def planes(k):
        P = max(1, -(-k // spp))
        slots = np.where(rng.random((P, spp, n)) < 0.5,
                         rng.integers(0, k + 2, (P, spp, n)),
                         top - rng.integers(0, 3, (P, spp, n)))
        out = np.zeros((P, n), np.uint64)
        for sl in range(spp):
            out |= slots[:, sl].astype(np.uint64) << np.uint64(code * sl)
        return out.astype(np.uint32).view(np.int32)

    s0 = (rng.integers(0, max(1, n // ncls), (B, G, 8, 128)) * ncls) \
        .astype(np.int32)
    j0 = rng.integers(0, W + 1, (B, G, 8, 128)).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in
            (data.numpy(), s0, j0, t_next, planes(R), planes(T), t_cmeta)]
    kw = dict(W=W, CPW=cpw, BITS=bits, CODE=code, R=R, T=T)
    before = ttdfa.tdfa_scan_launches
    got = ttdfa.tdfa_scan(*args, **kw)
    torch.cuda.synchronize()
    assert ttdfa.tdfa_scan_launches == before + 1
    want = ttdfa.tdfa_scan_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _tdfa_edge_case(rng, bits, code, R, T, identity=False, rows=2):
    """Random tagged tables as above at the register-bucket edges; with
    ``identity`` every register-source word is the identity (register k
    from register k), so only commits change anything."""
    cpw = 32 // bits
    B, G, W = 1, 8, 4 * cpw
    Jw = (W + 256) // cpw
    n = rows * 128
    ncls = 16 if bits == 4 else 40
    spp = 32 // code
    top = (1 << code) - 1
    words = rng.integers(0, 1 << 32, (B, Jw, G, 8, 128), dtype=np.uint64)
    data = words.astype(np.uint32).view(np.int32)
    t_next = (rng.integers(0, max(1, n // ncls), n) * ncls).astype(np.int32)
    t_cmeta = np.where(rng.random(n) < 0.3,
                       1 | (rng.integers(0, 128, n) << 1),
                       rng.integers(0, 1 << 20, n) << 1).astype(np.int32)

    def planes(k, ident):
        P = max(1, -(-k // spp))
        if ident:
            slots = np.broadcast_to(np.arange(P * spp).reshape(P, spp, 1),
                                    (P, spp, n))
        else:
            slots = np.where(rng.random((P, spp, n)) < 0.5,
                             rng.integers(0, k + 2, (P, spp, n)),
                             top - rng.integers(0, 3, (P, spp, n)))
        out = np.zeros((P, n), np.uint64)
        for sl in range(spp):
            out |= slots[:, sl].astype(np.uint64) << np.uint64(code * sl)
        return out.astype(np.uint32).view(np.int32)

    s0 = (rng.integers(0, max(1, n // ncls), (B, G, 8, 128)) * ncls) \
        .astype(np.int32)
    j0 = rng.integers(0, W + 1, (B, G, 8, 128)).astype(np.int32)
    arrs = (data, s0, j0, t_next, planes(R, identity), planes(T, False),
            t_cmeta)
    return arrs, dict(W=W, CPW=cpw, BITS=bits, CODE=code, R=R, T=T)


@pytest.mark.parametrize("code", [4, 8, 16])
@pytest.mark.parametrize("R,T", [(4, 4), (5, 6), (8, 8), (9, 4), (4, 9),
                                 (13, 13), (5, 13)])
def test_tdfa_kernel_at_the_register_bucket_edges(cuda, code, R, T):
    """R and T at the edges of the register buckets (8, 13, 24) of the
    kernel's register-file variants, for each code width; classes run
    past the table."""
    rng = np.random.default_rng(code * 1000 + R * 30 + T)
    arrs, kw = _tdfa_edge_case(rng, 4 if R % 2 else 8, code, R, T)
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    got = ttdfa.tdfa_scan(*args, **kw)
    torch.cuda.synchronize()
    want = ttdfa.tdfa_scan_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("code,R,T", [(4, 5, 6), (8, 13, 2)])
def test_tdfa_kernel_with_identity_register_words(cuda, code, R, T):
    """Every register-source word the identity: the registers carry over
    untouched except where a commit reads them."""
    rng = np.random.default_rng(code + R)
    arrs, kw = _tdfa_edge_case(rng, 4, code, R, T, identity=True)
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    got = ttdfa.tdfa_scan(*args, **kw)
    torch.cuda.synchronize()
    want = ttdfa.tdfa_scan_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_find_runs_on_the_card(cuda):
    import sregex_tpu_torch
    sc = sregex_tpu_torch.compile_pattern(rb"status=([0-9]+) user=([a-z_]+)")
    assert sc._tdfa_spec.t_next.device.type == "cuda"
    sc.DEVICE_THRESHOLD = 1
    data = b"status= user=x " * 20000 + b"status=404 user=bob_x "
    host = sregex_tpu_torch.compile_pattern(
        rb"status=([0-9]+) user=([a-z_]+)", device=None)
    before = ttdfa.tdfa_scan_launches
    assert sc.find(data) == host.find(data)
    assert ttdfa.tdfa_scan_launches == before + 1
    assert sc.stats().certified is True


def _phi_case(rng, S, bits, ncls, big, B=2, G=8, K=512):
    """Random words (classes up to 2**bits, past the table too), a random
    fused table of ceil(S*ncls/128) rows, and the kernel's keywords."""
    cpw = 32 // bits
    Kw = K // cpw
    rows = -(-(S * ncls) // 128)
    table = (rng.integers(0, S, rows * 128) * ncls
             | rng.integers(0, 2, rows * 128) << 20).astype(np.int32)
    kw = dict(Kw=Kw, CPW=cpw, BITS=bits, S=S, NCLS=ncls)
    if big:
        sb = -(-S // 128)
        kw["SB"] = 1 << (sb - 1).bit_length()
        P = -(-Kw // 128)
    else:
        kw["NSEG"] = max(1, 128 // S)
        kw["WL"] = 128 // kw["NSEG"]
        P = -(-Kw // kw["WL"])
    words = rng.integers(0, 1 << 32, (B, P, G, 8, 128), dtype=np.uint64)
    data = words.astype(np.uint32).view(np.int32)
    return data, table, kw


def _phi_valid(kw):
    """[8, 128] bool: the slots the TPU kernel computes for a chunk and
    entry state (the others are padding)."""
    sub = torch.arange(8)[:, None]
    lane = torch.arange(128)[None, :]
    if "SB" in kw:
        return ((sub % kw["SB"]) * 128 + lane < kw["S"]).expand(8, 128)
    return (lane < kw["NSEG"] * kw["S"]).expand(8, 128)


@pytest.mark.parametrize("S,bits,ncls,count", [
    (3, 4, 16, True), (4, 4, 3, False), (50, 8, 20, True),
    (128, 4, 8, False), (128, 8, 8, True), (3, 8, 256, False)])
def test_phi_kernel_equals_plain_version(cuda, S, bits, ncls, count):
    rng = np.random.default_rng(S * 10 + bits)
    data, table, kw = _phi_case(rng, S, bits, ncls, big=False)
    args = [torch.from_numpy(a).to(cuda) for a in (data, table)]
    k = tphi.stride_k(S, ncls, kw["CPW"], table.size, (8, 4, 2))
    st = torch.from_numpy(tphi.stride_table(table, S, ncls, k, count))
    before = tphi.phi_scan_launches
    got = tphi.phi_scan(*args, COUNT=count, stride=(k, st.to(cuda)), **kw)
    torch.cuda.synchronize()
    assert tphi.phi_scan_launches == before + 1
    want = tphi.phi_scan_ref(*args, COUNT=count, **kw)
    valid = _phi_valid(kw).to(cuda)
    for g, w in zip(got, want):
        assert torch.equal(g[..., valid], w[..., valid])


@pytest.mark.parametrize("S,bits,ncls,count", [
    (139, 4, 16, True), (501, 4, 16, False), (1000, 4, 8, True),
    (139, 8, 58, False)])
def test_phi_big_kernel_equals_plain_version(cuda, S, bits, ncls, count):
    """Up to 64 rows (8192 entries), the card's row cap."""
    rng = np.random.default_rng(S + bits)
    data, table, kw = _phi_case(rng, S, bits, ncls, big=True)
    assert table.size <= 64 * 128
    args = [torch.from_numpy(a).to(cuda) for a in (data, table)]
    k = tphi.stride_k(S, ncls, kw["CPW"], table.size)
    st = torch.from_numpy(tphi.stride_table(table, S, ncls, k, count))
    before = tphi.phi_big_scan_launches
    got = tphi.phi_big_scan(*args, COUNT=count, stride=(k, st.to(cuda)),
                            **kw)
    torch.cuda.synchronize()
    assert tphi.phi_big_scan_launches == before + 1
    want = tphi.phi_big_scan_ref(*args, COUNT=count, **kw)
    valid = _phi_valid(kw).to(cuda)
    for g, w in zip(got, want):
        assert torch.equal(g[..., valid], w[..., valid])


@pytest.mark.parametrize("S,bits,ncls", [(139, 4, 3), (501, 4, 3),
                                         (1000, 4, 2), (139, 8, 5)])
@pytest.mark.parametrize("words", ["in", "mixed"])
def test_phi_big_kernel_k_gram_walk(cuda, S, bits, ncls, words):
    """Every class below ncls (the k-gram path on every word), or one
    word in ten with a class code past ncls (the single steps between
    k-gram words): the kernel at each k in (1, 2, 4) that divides the
    word and fits shared memory equals the plain version."""
    rng = np.random.default_rng(S * 3 + bits + len(words))
    cpw = 32 // bits
    K = 2048
    Kw = K // cpw
    rows = -(-(S * ncls) // 128)
    table = (rng.integers(0, S, rows * 128) * ncls
             | rng.integers(0, 2, rows * 128) << 20).astype(np.int32)
    SB = 1 << (-(-S // 128) - 1).bit_length()
    P = -(-Kw // 128)
    cls = rng.integers(0, ncls, (2, P, 8, 8, 128, cpw))
    if words == "mixed":
        bad = rng.random(cls.shape[:-1]) < 0.1
        cls[..., 0] = np.where(bad, rng.integers(ncls, 1 << bits, bad.shape),
                               cls[..., 0])
    w = np.zeros(cls.shape[:-1], np.int64)
    for j in range(cpw):
        w |= cls[..., j] << (bits * j)
    data = torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(cuda)
    tab = torch.from_numpy(table).to(cuda)
    kw = dict(Kw=Kw, CPW=cpw, BITS=bits, S=S, SB=SB, NCLS=ncls)
    valid = _phi_valid(kw).to(cuda)
    for count in (True, False):
        want = tphi.phi_big_scan_ref(data, tab, COUNT=count, **kw)
        for k in (1, 2, 4):
            if cpw % k or S * ncls ** k + tab.numel() + 256 \
                    > tphi.STRIDE_SMEM_ENTRIES:
                continue
            st = torch.from_numpy(tphi.stride_table(
                table, S, ncls, k, count)).to(cuda)
            got = tphi.phi_big_scan(data, tab, COUNT=count, stride=(k, st),
                                    **kw)
            torch.cuda.synchronize()
            for g, v in zip(got, want):
                assert torch.equal(g[..., valid], v[..., valid]), (k, count)


@pytest.mark.parametrize("S,bits,ncls", [(1, 4, 2), (3, 4, 3), (4, 4, 3),
                                         (5, 4, 5), (9, 4, 4), (128, 4, 8),
                                         (50, 8, 20), (3, 8, 256)])
@pytest.mark.parametrize("words", ["in", "mixed"])
def test_phi_kernel_k_gram_walk(cuda, S, bits, ncls, words):
    """The lane-packed kernel at each k in (8, 4, 2, 1) that divides the
    word and fits shared memory: every class below ncls (the k-gram path
    on every word), or one word in ten with a class code past ncls (the
    single steps between k-gram words), COUNT and scan, equal to the
    plain version on the valid slots."""
    rng = np.random.default_rng(S * 5 + bits + len(words))
    cpw = 32 // bits
    K = 2048
    Kw = K // cpw
    rows = -(-(S * ncls) // 128)
    table = (rng.integers(0, S, rows * 128) * ncls
             | rng.integers(0, 2, rows * 128) << 20).astype(np.int32)
    nseg = max(1, 128 // S)
    WL = 128 // nseg
    P = -(-Kw // WL)
    cls = rng.integers(0, ncls, (2, P, 8, 8, 128, cpw))
    if words == "mixed" and ncls < 1 << bits:
        bad = rng.random(cls.shape[:-1]) < 0.1
        cls[..., 0] = np.where(bad, rng.integers(ncls, 1 << bits, bad.shape),
                               cls[..., 0])
    w = np.zeros(cls.shape[:-1], np.int64)
    for j in range(cpw):
        w |= cls[..., j] << (bits * j)
    data = torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(cuda)
    tab = torch.from_numpy(table).to(cuda)
    kw = dict(Kw=Kw, WL=WL, CPW=cpw, BITS=bits, S=S, NSEG=nseg, NCLS=ncls)
    valid = _phi_valid(kw).to(cuda)
    for count in (True, False):
        want = tphi.phi_scan_ref(data, tab, COUNT=count, **kw)
        for k in (8, 4, 2, 1):
            if cpw % k or S * ncls ** k + tab.numel() + 256 \
                    > tphi.STRIDE_SMEM_ENTRIES:
                continue
            st = torch.from_numpy(tphi.stride_table(
                table, S, ncls, k, count)).to(cuda)
            got = tphi.phi_scan(data, tab, COUNT=count, stride=(k, st), **kw)
            torch.cuda.synchronize()
            for g, v in zip(got, want):
                assert torch.equal(g[..., valid], v[..., valid]), (k, count)


def test_phi_scan_needs_its_stride_on_the_card(cuda):
    rng = np.random.default_rng(1)
    data, table, kw = _phi_case(rng, 4, 4, 3, big=False)
    args = [torch.from_numpy(a).to(cuda) for a in (data, table)]
    with pytest.raises(TypeError, match="stride"):
        tphi.phi_scan(*args, COUNT=True, **kw)


def test_phi_tier_runs_on_the_card(cuda):
    import sregex_tpu_torch
    sc = sregex_tpu_torch.compile_pattern(rb"b(?:aa)*b")
    host = sregex_tpu_torch.compile_pattern(rb"b(?:aa)*b", device=None)
    sc.DEVICE_THRESHOLD = 1 << 12
    rng = np.random.default_rng(0)
    runs = rng.integers(60, 300, 4000)
    data = b"".join(b"a" * int(r) + b"b" for r in runs)
    for _ in range(2):
        assert sc.count(data) == host.count(data)
    assert sc._phi_active and sc._phi.fused.device.type == "cuda"
    before = tphi.phi_scan_launches
    assert sc.count(data) == host.count(data)
    assert sc.scan(data) == host.scan(data)
    assert tphi.phi_scan_launches == before + 2
    assert sc.stats().tier == "PhiTables" and sc.stats().repaired == 0


def _gated_case(rng, bits, rows, ncls, n_esc, mapped, B2=4, G=8):
    """Random phase-2 inputs at B2 block rows of G tiles: class codes below
    ncls, a table of rows*128 entries (next states multiples of ncls,
    match fields 0-2), entry states a third of them off the rows, random
    freezes.  ``mapped``: the words are a corpus of B2 + 2 block rows and
    the slots read chunks of an ascending random map (padding: chunk 0);
    else the windows themselves.  Returns (args, sel, fused numpy)."""
    cpw = {3: 10, 4: 8, 8: 4}[bits]
    W = 4 * cpw
    Jw = (W + 256 // (2 * cpw) * (2 * cpw)) // cpw
    Bc = B2 + 2 if mapped else B2
    cls = rng.integers(0, ncls, (Bc, Jw, G, 8, 128, cpw), dtype=np.int64)
    words = np.zeros(cls.shape[:-1], np.int64)
    for k in range(cpw):
        words |= cls[..., k] << (bits * k)
    S = rows * 128 // ncls
    fused = (rng.integers(0, S, rows * 128) * ncls
             | rng.integers(0, 3, rows * 128) << 20).astype(np.int32)
    s0 = rng.integers(0, S, (B2, G, 8, 128)) * ncls
    odd = rng.random(s0.shape) < 1 / 3
    s0[odd] = rng.integers(-300, S * ncls + 3000, int(odd.sum()))
    j0 = rng.integers(0, W + 1, (B2, G, 8, 128))
    sel = None
    if mapped:
        chunks = Bc * G * 1024
        m = np.zeros(B2 * G * 1024, np.int64)
        n = min(n_esc, m.size)
        m[:n] = np.sort(rng.choice(chunks, n, replace=False))
        sel = torch.from_numpy(m.astype(np.int32))
    args = [torch.from_numpy(a.astype(np.int32))
            for a in (words.astype(np.uint32).view(np.int32), s0, j0,
                      fused)]
    return args, sel, fused, dict(W=W, CPW=cpw, BITS=bits)


# (bits, rows, ncls, route): narrow and wide tables in shared memory, big
# ones by the 16-bit table and from global memory
GATED_ROUTES = [(4, 1, 16, "smem"), (3, 1, 8, "smem"), (8, 98, 27, "smem"),
                (8, 821, 27, "big16"), (4, 600, 16, "big16"),
                (8, 821, 27, "global"), (4, 600, 16, "global")]


@pytest.mark.parametrize("bits,rows,ncls,route", GATED_ROUTES)
@pytest.mark.parametrize("mapped", [False, True], ids=["windows", "sel"])
@pytest.mark.parametrize("n_esc", [0, 1, 8 * 1024, 8 * 1024 + 1, 32768])
def test_gated_kernel_equals_plain_version(cuda, bits, rows, ncls, route,
                                           mapped, n_esc):
    """The gated phase-2 kernel at CAP 32768 (4 block rows of 8 tiles) on
    each route, reading block-layout windows or the corpus through a slot
    map: the active rows equal the plain version, the gated-off rows keep
    the sentinel the output planes were filled with."""
    from sregex_tpu_torch.ops import core as tcore
    rng = np.random.default_rng(bits * 7 + rows + n_esc + mapped)
    args, sel, fused, kw = _gated_case(rng, bits, rows, ncls, n_esc, mapped)
    args = [t.to(cuda) for t in args]
    sel = None if sel is None else sel.to(cuda)
    big = route != "smem"
    t16 = tbig.big16_table(fused, ncls, rows * 128 // ncls, bits, cuda) \
        if route == "big16" else None
    assert (t16 is not None) == (route == "big16")
    ne = torch.tensor([n_esc], dtype=torch.int32, device=cuda)
    out = tuple(torch.full_like(args[1], -7) for _ in range(3))
    before = (tcore.gated_scan_launches, tcore.gated_route_launches[route])
    got = tcore.gated_scan(*args, ne, big=big, t16=t16, sel=sel, out=out,
                           **kw)
    torch.cuda.synchronize()
    assert (tcore.gated_scan_launches,
            tcore.gated_route_launches[route]) == (before[0] + 1,
                                                   before[1] + 1)
    want = tcore.gated_scan_ref(*args, ne, sel=sel, **kw)
    nblk = min(4, -(-n_esc // (8 * 1024)))
    for g, w in zip(got, want):
        assert torch.equal(g[:nblk], w[:nblk])
        assert bool((g[nblk:] == -7).all())


def test_fused_count_reads_windows_in_place_on_the_card(cuda, monkeypatch):
    """A SREGEX_FUSED=1 count of a big machine whose table big16_table
    holds goes through the gated kernel's 16-bit route, reading the
    escaped chunks in place: _gather_windows is never called."""
    import sregex_tpu_torch
    from sregex_tpu_torch.ops import core as tcore
    monkeypatch.setenv("SREGEX_FUSED", "1")

    def no_gather(*a, **k):
        raise AssertionError("the card gathered the phase-2 windows")

    monkeypatch.setattr(tcore, "_gather_windows", no_gather)
    rng = np.random.default_rng(9)
    text = rng.choice(np.frombuffer(b"bcdxyz ", np.uint8), 8 << 20)
    # the a's lie between the Scanner's sample slices (its head and thirds),
    # so the sampled core leaves their states out and their chunks escape
    text[rng.integers(1 << 20, 2 << 20, 300)] = ord("a")
    data = text.tobytes()
    sc = sregex_tpu_torch.compile_pattern("a.{11}b")
    host = sregex_tpu_torch.compile_pattern("a.{11}b", device=None)
    assert sc._spec.t16 is not None
    before = (tcore.gated_scan_launches,
              tcore.gated_route_launches["big16"])
    assert sc.count(data) == host.count(data)
    assert sc.stats().tier == "CoreTables"
    assert sc._fusedct.last_escapes[0] > 0
    assert (tcore.gated_scan_launches,
            tcore.gated_route_launches["big16"]) == (before[0] + 1,
                                                     before[1] + 1)


def test_core_tiers_run_on_the_card(cuda, monkeypatch):
    """With SREGEX_FUSED=1 a big-tier machine counts and scans through
    the fused tier (phase 2 on the gated big kernel); a machine with no
    static tier goes through the legacy core; both equal to the native
    engine."""
    import sregex_tpu_torch
    from sregex_tpu_torch.ops import core as tcore
    monkeypatch.setenv("SREGEX_FUSED", "1")
    rng = np.random.default_rng(5)
    text = rng.choice(np.frombuffer(b"bcdxyz ", np.uint8), 8 << 20)
    text[rng.integers(0, len(text) - 16, 300)] = ord("a")
    data = text.tobytes()
    for pat, tier in (("a.{11}b", "SpecTablesBig"),
                      ("a.{10}b|cdefghijklmnopqrstuvwxyz", None)):
        sc = sregex_tpu_torch.compile_pattern(pat)
        host = sregex_tpu_torch.compile_pattern(pat, device=None)
        assert type(sc._spec).__name__ == tier or sc._spec is tier
        before = (tcore.gated_scan_launches, _spec_launches())
        assert sc.count(data) == host.count(data)
        assert sc.stats().tier == "CoreTables"
        assert sc.scan(data) == host.scan(data)
        if tier:
            assert sc._fusedct not in (None, False)
            assert tcore.gated_scan_launches == before[0] + 2
        else:
            assert sc._coret not in (None, False)
        assert _spec_launches() == before[1] + 2


def test_big_machines_stay_on_the_static_big_tier_on_the_card(cuda):
    """Without SREGEX_FUSED=1 the card's band keeps a big-tier machine on
    the static big kernel, equal to the native engine."""
    import sregex_tpu_torch
    from sregex_tpu_torch.ops import core as tcore
    rng = np.random.default_rng(6)
    text = rng.choice(np.frombuffer(b"bcdxyz ", np.uint8), 8 << 20)
    text[rng.integers(0, len(text) - 16, 300)] = ord("a")
    data = text.tobytes()
    sc = sregex_tpu_torch.compile_pattern("a.{11}b")
    host = sregex_tpu_torch.compile_pattern("a.{11}b", device=None)
    assert sc._spec.t16 is not None       # 6,144 states x 3 classes
    before = (tcore.gated_scan_launches, tbig.big_smem_launches)
    assert sc.count(data) == host.count(data)
    assert sc.scan(data) == host.scan(data)
    assert sc.stats().tier == "SpecTablesBig"
    assert sc._fusedct is False and sc._coret is False
    assert tcore.gated_scan_launches == before[0]
    assert tbig.big_smem_launches == before[1] + 2


def test_lazy_machine_runs_on_the_card(cuda):
    """A pattern past the eager DFA budget constructs on the card and
    counts through the legacy core over the lazy machine, equal to the
    lazy host walk."""
    import sregex_tpu_torch
    rng = np.random.default_rng(8)
    text = rng.choice(np.frombuffer(b"bcdfgz ", np.uint8), 8 << 20)
    text[rng.integers(0, len(text) - 16, 3000)] = ord("a")
    data = text.tobytes()
    sc = sregex_tpu_torch.compile_pattern(rb"a.{13}b")
    host = sregex_tpu_torch.compile_pattern(rb"a.{13}b", device=None)
    assert sc.dfa is None and sc.device.type == "cuda"
    before = _spec_launches()
    assert sc.count(data) == host.count(data)
    assert sc.stats().tier == "LazyCoreTables"
    assert sc.scan(data) == host.scan(data)
    assert sc.find(data) == host.find(data)
    assert _spec_launches() >= before + 2


def test_stream_scanner_runs_on_the_card(cuda):
    """StreamScanner in 2 MB chunks from carried states, on the static
    tier and on the legacy core, equal to the native engine."""
    import sregex_tpu_torch
    from sregex_tpu_torch.consts import SRE_AGAIN, SRE_OK
    rng = np.random.default_rng(9)
    for pattern, alpha, lit in (
            ("(?:a|b)aa(?:aa|bb)cc(?:a|b)", b"bcx", b"xaaabbccb"),
            ("a.{10}b|cdefghijklmnopqrstuvwxyz", b"acdxyz ",
             b"cdefghijklmnopqrstuvwxyz")):
        text = rng.choice(np.frombuffer(alpha, np.uint8), 12 << 20)
        data = bytearray(text.tobytes())
        data[(10 << 20) - 5:(10 << 20) - 5 + len(lit)] = lit
        data = bytes(data)
        host = sregex_tpu_torch.compile_pattern(pattern, device=None)
        first, _ = host._native.scan_first(data, 0)
        ss = sregex_tpu_torch.StreamScanner(host.dfa)
        before = _spec_launches()
        rc = SRE_AGAIN
        for lo in range(0, len(data), 2 << 20):
            rc, off = ss.exec(data[lo:lo + (2 << 20)])
            if rc != SRE_AGAIN:
                break
        assert (rc, off) == (SRE_OK, first) and first > 10 << 20
        assert ss.matched_regex == host.scan(data)[0]
        assert _spec_launches() > before


def _dictionary(n, seed):
    """n distinct keywords of 6-12 lowercase letters."""
    rng = np.random.default_rng(seed)
    words = set()
    while len(words) < n:
        words.add(bytes(rng.integers(97, 123, int(rng.integers(6, 13)))
                        .astype(np.uint8)))
    return sorted(words)


@pytest.mark.parametrize("tier", ["SpecTablesAffine", "SpecTablesBig"])
def test_stream_scanner_static_tiers_run_on_the_card(cuda, tier):
    """StreamScanner in 2 MB chunks on the affine tier (the base64
    detector, its relaid table) and the big tier (a dictionary past the
    wide tier, its 16-bit table), most chunks entered in non-zero
    carried states: equal to the native engine."""
    import sregex_tpu_torch
    from sregex_tpu_torch import stream as tstream
    from sregex_tpu_torch.consts import SRE_AGAIN, SRE_OK
    rng = np.random.default_rng(11)
    if tier == "SpecTablesAffine":
        pattern, alpha = rb"[A-Za-z0-9+/]{400,499}=", b"Ab9+/ "
        lit = b" " + b"Q" * 450 + b"="
        launches = lambda: taff.affine_scan_launches
    else:
        pattern = _dictionary(100, 5)
        alpha, lit = b"abcdefgh ", b" " + pattern[37] + b" "
        launches = lambda: tbig.big_smem_launches
    text = rng.choice(np.frombuffer(alpha, np.uint8), 12 << 20)
    data = bytearray(text.tobytes())
    data[(10 << 20) - 5:(10 << 20) - 5 + len(lit)] = lit
    data = bytes(data)
    host = sregex_tpu_torch.compile_pattern(pattern, device=None)
    first, st = host._native.scan_first(data, 0)
    ss = sregex_tpu_torch.StreamScanner(host.dfa)
    states, orig = [], tstream.spec_scan_bytes

    def spy(tables, chunk, **kw):
        states.append(kw["entry_state"])
        return orig(tables, chunk, **kw)

    before = launches()
    tstream.spec_scan_bytes = spy
    try:
        rc = SRE_AGAIN
        for lo in range(0, len(data), 2 << 20):
            rc, off = ss.exec(data[lo:lo + (2 << 20)])
            if rc != SRE_AGAIN:
                break
    finally:
        tstream.spec_scan_bytes = orig
    assert type(ss._tables).__name__ == tier
    assert (rc, off) == (SRE_OK, first)
    assert ss.matched_regex == host.dfa.id_at(st, data[first])
    assert len(states) >= 3 and sum(s != 0 for s in states) >= 2
    assert launches() >= before + len(states)


@pytest.mark.parametrize("fused", [False, True])
def test_finditer_index_runs_on_the_card(cuda, monkeypatch, fused):
    """make_index on the card (the reverse static tier, or under
    SREGEX_FUSED=1 a dictionary's fused reverse core): its map equals a
    native walk of the reversed corpus, and finditer and sub equal the
    host walker's."""
    import sregex_tpu_torch
    from sregex_tpu_torch.ops import core as tcore
    rng = np.random.default_rng(10)
    if fused:
        monkeypatch.setenv("SREGEX_FUSED", "1")
        words = sorted({bytes(rng.integers(97, 123, 8).astype(np.uint8))
                        for _ in range(20)})
        pattern = words
    else:
        pattern = rb"status=([0-9]+) user=([a-z_]+)"
    text = rng.choice(np.frombuffer(b"abcdefghijklmnop =", np.uint8),
                      20 << 20)
    data = bytearray(text.tobytes())
    plant = b" %s " % (words[7] if fused else b"status=404 user=bob")
    for pos in range(1000, len(data) - 64, 1 << 18):
        data[pos:pos + len(plant)] = plant
    data = bytes(data)
    sc = sregex_tpu_torch.compile_pattern(pattern)
    host = sregex_tpu_torch.compile_pattern(pattern, device=None)
    assert host._tdfa_walker() is not None
    g0 = tcore.gated_scan_launches
    idx = sc.make_index(data)
    assert idx.route == "device flip"
    if fused:
        assert idx.tables is sc._rev_fusedct
        assert tcore.gated_scan_launches > g0
    rev = sc._rev_dfa()
    rdata, s = data[::-1], 0
    for c in range(idx.C):
        assert idx.entries[c] == s
        k, s = rev.count(rdata[c * idx.CHUNK:(c + 1) * idx.CHUNK], s)
        assert idx.counts[c] == k
    want = host.findall(data)
    assert len(want) >= 70
    assert sc.findall(data, index=idx) == want
    assert sc.sub(b"<$0>", data, index=idx) == host.sub(b"<$0>", data)


def _reusing(data, size):
    """A producer that refills one bytearray between yields."""
    buf = bytearray(size)
    for i in range(0, len(data), size):
        chunk = data[i:i + size]
        buf[:len(chunk)] = chunk
        yield memoryview(buf)[:len(chunk)]


@pytest.mark.parametrize("in_flight", [1, 2, 3])
def test_pipeline_on_the_card_equals_the_cpu_path(cuda, in_flight):
    """pipelined_count / pipelined_scan staged through pinned slots on a
    copy stream equal the same pipeline on CPU tensors (the plain
    versions) and the native engine, from a producer that refills one
    buffer, on the narrow (two-code) and the wide tier."""
    import sregex_tpu_torch
    from sregex_tpu_torch.ops import pipeline as tpipe
    rng = np.random.default_rng(in_flight)
    # alphabets in which only the planted literal matches
    for pattern, alpha, lit in (
            ("(?:a|b)aa(?:aa|bb)cc(?:a|b)", b"bcx", b"xaaabbccb"),
            ([b"cat", b"dog(s)?", b"bird", b"fishes"], b"caobirfsh x",
             b" fishes ")):
        host = sregex_tpu_torch.compile_pattern(pattern, device=None)
        card = sregex_tpu_torch.Scanner(host.program, dfa=host.dfa)
        cpu = sregex_tpu_torch.Scanner(host.program, device="cpu",
                                       dfa=host.dfa)
        text = rng.choice(np.frombuffer(alpha, np.uint8), 5 << 20)
        data = bytearray(text.tobytes())
        data[(3 << 20) + 1:(3 << 20) + 1 + len(lit)] = lit
        data = bytes(data)
        size = (1 << 20) + 333
        before = _spec_launches()
        got = tpipe.pipelined_count(card._spec, _reusing(data, size),
                                    in_flight=in_flight)
        assert _spec_launches() > before
        assert got == tpipe.pipelined_count(cpu._spec, _reusing(data, size),
                                             in_flight=in_flight)
        k, st = host._native.count(data, 0)
        assert got == (st, k)
        got = tpipe.pipelined_scan(card._spec, _reusing(data, size),
                                   in_flight=in_flight)
        assert got == tpipe.pipelined_scan(cpu._spec, _reusing(data, size),
                                           in_flight=in_flight)
        f, st = host._native.scan_first(data, 0)
        assert got[:2] == (st, f) and f > 3 << 20


def test_pipeline_ring_grows_and_stages_in_pinned_memory(cuda):
    """Every slot's host buffers are pinned and its raw bytes are on the
    card; a segment larger than the ring's buffers grows them, and the
    count stays exact."""
    import sregex_tpu_torch
    from sregex_tpu_torch.ops import pipeline as tpipe
    sc = sregex_tpu_torch.compile_pattern("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
    rng = np.random.default_rng(5)
    data = bytearray(rng.choice(np.frombuffer(b"abcx", np.uint8),
                                9 << 20).tobytes())
    for pos in range(1000, len(data) - 16, 1 << 19):
        data[pos:pos + 9] = b"xaaabbccb"
    data = bytes(data)
    pipe = tpipe._Pipeline(sc._spec, 2048, 0, True, 2)
    slots, sizes = [], []
    for lo, hi in ((0, 1 << 20), (1 << 20, 2 << 20), (2 << 20, 3 << 20),
                   (3 << 20, 9 << 20)):
        pipe.dispatch([np.frombuffer(data[lo:hi], np.uint8)])
        slot = pipe.pending[-1][0]
        assert slot.host.is_pinned() and slot.tail.is_pinned()
        assert slot.planes.is_pinned()
        assert slot.dev[0].device.type == "cuda"
        slots.append(slot)
        sizes.append(slot.host.numel())
    # the fourth segment reuses the first slot, freed by its fold
    assert slots[3] is slots[0]
    assert sizes[3] >= 6 << 20 > sizes[0] == 1 << 20
    pipe.drain()
    k, _ = sc._native.count(data, 0)
    assert pipe.total == k and not pipe.pending
    assert len(pipe.free) == 3


def test_pipeline_slot_buffer_waits_for_the_compute_stream(cuda):
    """A slot's new device buffer can reuse a block freed on the compute
    stream while work that reads it is still queued there; the copy
    stream must not write it before that work ends."""
    from sregex_tpu_torch.ops import pipeline as tpipe
    copy = torch.cuda.Stream(cuda)
    slot = tpipe._Slot([cuda], 32, {cuda: copy})
    torch.cuda._sleep(500_000_000)      # the compute stream busy ~0.3 s
    slot.reserve(1 << 20, [1 << 20])
    done = torch.cuda.Event()
    done.record(copy)
    assert not done.query()
    torch.cuda.synchronize()
    assert done.query()


def test_stream_methods_run_on_the_card(cuda):
    """count_stream / scan_stream / finditer_stream / sub_stream on the
    card equal the whole-corpus calls."""
    import sregex_tpu_torch
    pattern = rb"status=([0-9]+) user=([a-z_]+)"
    rng = np.random.default_rng(12)
    text = rng.choice(np.frombuffer(b"abcdefghijklmnop =", np.uint8),
                      20 << 20)
    data = bytearray(text.tobytes())
    plant = b" status=404 user=bob "
    for pos in range(1000, len(data) - 64, 1 << 18):
        data[pos:pos + len(plant)] = plant
    data = bytes(data)
    sc = sregex_tpu_torch.compile_pattern(pattern)
    segs = [data[i:i + (3 << 20) + 1] for i in range(0, len(data),
                                                     (3 << 20) + 1)]
    before = _spec_launches()
    assert sc.count_stream(segs) == sc.count(data)
    assert sc.scan_stream(iter(segs)) == sc.scan(data)
    assert sc.match_stream(segs)
    assert _spec_launches() > before
    want = sc.findall(data)
    assert len(want) >= 70
    assert list(sc.finditer_stream(segs)) == want
    assert b"".join(sc.sub_stream(b"<$1>", segs)) == \
        sc.sub(b"<$1>", data)[0]


def test_pipeline_cuts_large_segments_on_the_card(cuda, monkeypatch):
    """A segment past MAX_SEGMENT goes in whole-chunk pieces, one launch
    each, all through the device prep (the host prep, which would read
    the segment back from the card, is never reached), and counts and
    repairs as the uncut segment does."""
    import sregex_tpu_torch
    from sregex_tpu_torch.ops import pipeline as tpipe
    from sregex_tpu_torch.ops import prep as tprep
    from sregex_tpu_torch.ops.layout import effective_chunk
    sc = sregex_tpu_torch.compile_pattern("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
    rng = np.random.default_rng(8)
    data = bytearray(rng.choice(np.frombuffer(b"abcx", np.uint8),
                                (7 << 20) + 5).tobytes())
    for pos in range(1000, len(data) - 16, 1 << 19):
        data[pos:pos + 9] = b"xaaabbccb"
    data = bytes(data)
    want = tpipe.pipelined_count(sc._spec, [data])
    whole = sc._spec.last_repair

    def no_host_prep(*args, **kw):
        raise AssertionError("the pipeline reached the host prep")

    monkeypatch.setattr(tprep, "_prepare", no_host_prep)
    monkeypatch.setattr(tpipe, "MAX_SEGMENT", 1 << 20)
    before = _spec_launches()
    assert tpipe.pipelined_count(sc._spec, [data]) == want
    K = effective_chunk(sc._spec, tpipe.DEFAULT_K)
    assert _spec_launches() - before == -(-len(data) // ((1 << 20) // K * K))
    assert sc._spec.last_repair == whole
    k, st = sc._native.count(data, 0)
    assert want == (st, k)


def _batch_docs(rng, alpha, plants, n_docs, lo=512, hi=256 << 10):
    """n_docs documents of log-uniform lengths in [lo, hi) bytes of
    ``alpha``, each with one of ``plants`` at a random place where it
    fits, and an empty and a 13-byte document."""
    docs = []
    for i in range(n_docs):
        n = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        d = bytearray(rng.choice(np.frombuffer(alpha, np.uint8), n)
                      .tobytes())
        p = plants[i % len(plants)]
        if n > len(p) and i % 3:
            at = int(rng.integers(0, n - len(p)))
            d[at:at + len(p)] = p
        docs.append(bytes(d))
    return docs + [b"", bytes(alpha[:1]) * 13]


def test_batch_methods_run_on_the_card(cuda):
    """count_many, scan_many and find_many on the card equal the native
    engine's per-document results, each in one launch of its kernel."""
    import sregex_tpu_torch
    rng = np.random.default_rng(41)
    pattern = rb"status=([0-9]+) user=([a-z_]+)"
    docs = _batch_docs(rng, b"abcdefghijklmnop =", [b" status=404 user=bob "],
                       120)
    assert sum(map(len, docs)) >= 4 << 20
    sc = sregex_tpu_torch.compile_pattern(pattern)
    host = sregex_tpu_torch.compile_pattern(pattern, device=None)
    before = _spec_launches()
    assert sc.count_many(docs) == [host.count(d) for d in docs]
    assert sc.stats().api == "count_many"
    assert sc.scan_many(docs) == [host.scan(d) for d in docs]
    assert _spec_launches() == before + 2
    before = ttdfa.tdfa_scan_launches
    assert sc.find_many(docs) == [host.find(d) for d in docs]
    assert ttdfa.tdfa_scan_launches == before + 1
    assert sc.stats().api == "find_many"


def test_fused_batch_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """_fused_batch on CUDA tensors (phase 2 on the gated kernel, the
    per-document fold in torch ops) equals _fused_batch on the same CPU
    tensors, escapes at document starts among them; count_many through it
    equals the native engine."""
    import sregex_tpu_torch
    from sregex_tpu_torch.ops import batch as tbatch
    from sregex_tpu_torch.ops import core as tcore
    monkeypatch.setenv("SREGEX_FUSED", "1")
    words = _dictionary(300, 4)
    rng = np.random.default_rng(42)
    docs = _batch_docs(rng, b"bcdefgh ", [b" " + w + b" " for w in words],
                       200)
    for i in range(0, 200, 7):      # keywords in document-start chunks
        docs[i] = words[i] + docs[i][len(words[i]):]
    scs = {d: sregex_tpu_torch.compile_pattern(words, device=d)
           for d in ("cpu", "cuda")}
    seen = {}
    real = tcore._fused_batch

    def keep(*args, **kw):
        out = real(*args, **kw)
        seen["args"], seen["kw"], seen["out"] = args, kw, out
        return out

    monkeypatch.setattr(tbatch, "_fused_batch", keep)
    fct = scs["cpu"]._batch_fused_core(docs)
    assert fct is not None and type(scs["cpu"]._spec).__name__ \
        == "SpecTablesBig"
    d = tbatch._fused_batch_dispatch(fct, scs["cpu"]._spec, docs, 2048,
                                     None, None)
    assert d["n_esc"] > 0
    args, kw, want = seen["args"], seen["kw"], seen["out"]
    gct = scs["cuda"]._batch_fused_core(docs)
    assert np.array_equal(gct.hot2full, fct.hot2full)
    cargs = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    cargs[5], cargs[6] = gct.inner, scs["cuda"]._spec
    cargs[7] = fct._h2f_dev.to(cuda)
    before = tcore.gated_scan_launches
    got = real(*cargs, **kw)
    torch.cuda.synchronize()
    assert tcore.gated_scan_launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    host = sregex_tpu_torch.compile_pattern(words, device=None)
    assert scs["cuda"].count_many(docs) == [host.count(d) for d in docs]
    assert scs["cuda"].stats().tier == "CoreTables"


@pytest.mark.parametrize("bits,rows,ncls,route", [
    (4, 1, 16, "smem"), (8, 98, 27, "smem"), (8, 821, 27, "big16"),
    (8, 821, 27, "global")])
def test_gated_kernel_with_frozen_slots_in_a_slot_map(cuda, bits, rows, ncls,
                                                      route):
    """Phase 2 of the fused batch: slots read in place through a slot map,
    j0 = W (the warmup frozen, the entry the seed) at random slots and 0
    elsewhere, equal to the plain version."""
    from sregex_tpu_torch.ops import core as tcore
    rng = np.random.default_rng(bits + rows)
    n_esc = 3 * 8 * 1024 + 5
    args, sel, fused, kw = _gated_case(rng, bits, rows, ncls, n_esc, True)
    j0 = np.where(rng.random(tuple(args[2].shape)) < 0.2, kw["W"], 0)
    args[1] = torch.zeros_like(args[1])
    args[2] = torch.from_numpy(j0.astype(np.int32))
    args = [t.to(cuda) for t in args]
    sel = sel.to(cuda)
    t16 = tbig.big16_table(fused, ncls, rows * 128 // ncls, bits, cuda) \
        if route == "big16" else None
    ne = torch.tensor([n_esc], dtype=torch.int32, device=cuda)
    got = tcore.gated_scan(*args, ne, big=route != "smem", t16=t16, sel=sel,
                           **kw)
    torch.cuda.synchronize()
    want = tcore.gated_scan_ref(*args, ne, sel=sel, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g[:4], w[:4])


HOT_CORE_PAT = rb"user=([a-z_]{1,40}) id=([0-9]{4,12})"
HOT_CORE_LINES = [b"t=1 auth user=alice id=41 ok\n", b"t=2 user=bob_x id=7\n",
                  b"t=3 api user=carol_s id=123 /a\n", b"t=4 user= id=9\n"]


def _hot_core_corpus(rng, n_lines, plant=None):
    lines = [HOT_CORE_LINES[i] for i in
             rng.integers(0, len(HOT_CORE_LINES), n_lines)]
    if plant is not None:
        lines[plant] = b"t=5 user=mallory id=31337 x\n"
    return b"".join(lines)


@pytest.mark.parametrize("entry", ["seed", "random"])
def test_tdfa_kernel_on_hot_core_planes(cuda, entry):
    """The tagged kernel over TdfaCoreTables planes (the ESC sink's row
    block: a self-loop, UNSET rebuilds, no commits) on a corpus whose
    spliced letters leave the core, entered as tdfa_spec_find enters it
    and from random kernel states, ESC among them: equal to the plain
    version."""
    import sregex_tpu_torch
    from sregex_tpu_torch.ops.prep import prepare_on_device
    rng = np.random.default_rng(13)
    prog = sregex_tpu_torch.compile_pattern(HOT_CORE_PAT, device=None).program
    ct = ttdfa.TdfaCoreTables(prog, _hot_core_corpus(rng, 20000), cuda)
    assert ct.is_core
    text = bytearray(_hot_core_corpus(rng, 120000, plant=90000))
    for at in rng.integers(0, len(text) - 16, 300).tolist():
        text[at:at + 6] = b"zz_q=1"
    data, _, _, _, B = prepare_on_device(ct, bytes(text), 2048)
    shape = (B, 8, 8, 128)
    if entry == "seed":
        s0 = torch.full(shape, ct.seed_premult, dtype=torch.int32)
        j0 = torch.zeros(shape, dtype=torch.int32)
        j0[0, 0, 0, 0] = ct.warmup
    else:
        s0 = torch.from_numpy((rng.integers(0, ct.H + 1, shape)
                               * ct.ncls).astype(np.int32))
        j0 = torch.from_numpy(rng.integers(0, ct.warmup + 1, shape)
                              .astype(np.int32))
    tabs, kw = ct.planes()
    args = [data, s0.to(cuda), j0.to(cuda), *tabs]
    before = ttdfa.tdfa_scan_launches
    got = ttdfa.tdfa_scan(*args, **kw)
    torch.cuda.synchronize()
    assert ttdfa.tdfa_scan_launches == before + 1
    want = ttdfa.tdfa_scan_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[0] == ct.esc_k * ct.ncls).any()


def test_find_through_the_hot_core_on_the_card(cuda):
    """A tagged machine past the card's dense budget: find certifies on
    the hot core in one tagged launch, equal to the native engines."""
    import sregex_tpu_torch
    rng = np.random.default_rng(14)
    data = _hot_core_corpus(rng, 200000, plant=150000)
    sc = sregex_tpu_torch.compile_pattern(HOT_CORE_PAT)
    host = sregex_tpu_torch.compile_pattern(HOT_CORE_PAT, device=None)
    assert sc._tdfa_spec is None
    sc.DEVICE_THRESHOLD = 1 << 20
    before = ttdfa.tdfa_scan_launches
    assert sc.find(data) == host.find(data) is not None
    st = sc.stats()
    assert (st.tier, st.certified) == ("TdfaCoreTables", True)
    assert ttdfa.tdfa_scan_launches == before + 1
    assert sc._tdfa_coret.t_next.device.type == "cuda"


@pytest.mark.parametrize("pattern", ["a.{10}b|cdefghijklmnopqrstuvwxyz",
                                     "a.{13}b|cdefghijklmnopqrstuvwxyz"])
def test_find_through_the_reverse_cores_on_the_card(cuda, pattern):
    """Text full of a's (no hot tagged core fits) with one match near the
    end: the reverse machine's legacy core, or its lazy core past the
    eager budget, locates the start on the card (core_scan_last_bytes),
    equal to the host engines."""
    import sregex_tpu_torch
    from sregex_tpu_torch.ops import core as tcore
    rng = np.random.default_rng(15)
    words = [b"alpha", b"delta", b"golf", b"hotel", b"kilo", b"papa",
             b"tango", b"zulu"]
    text = bytearray(b" ".join(words[i] for i in
                               rng.integers(0, len(words), 1 << 20)))
    gap = 10 if "{10}" in pattern else 13
    at = len(text) - 3000
    text[at:at + gap + 2] = b"a" + b"0" * gap + b"b"
    data = bytes(text)
    sc = sregex_tpu_torch.compile_pattern(pattern)
    host = sregex_tpu_torch.compile_pattern(pattern, device=None)
    before = _spec_launches()
    assert sc.find(data) == host.find(data) == (0, [at, at + gap + 2])
    assert sc._tdfa_coret is False
    rct = sc._rev_coret if sc.dfa is not None else sc._rev_lz_coret
    assert isinstance(rct, tcore.CoreTables) and rct.last_repair is not None
    assert _spec_launches() >= before + 2     # the prefilter and the locator


@pytest.mark.parametrize("fused", [False, True])
def test_precompile_on_the_card(cuda, monkeypatch, fused):
    """precompile on the card, then an exact count: on the static pair
    tier, and under SREGEX_FUSED=1 on the fused tier over a big-tier
    machine whose core the sample built."""
    import sregex_tpu_torch
    if fused:
        monkeypatch.setenv("SREGEX_FUSED", "1")
    pattern = "a.{11}b" if fused else "ab"
    rng = np.random.default_rng(16)
    text = rng.choice(np.frombuffer(b"bcdxyz ", np.uint8), 8 << 20)
    text[rng.integers(0, len(text) - 16, 300)] = ord("a")
    data = text.tobytes()
    sc = sregex_tpu_torch.compile_pattern(pattern)
    host = sregex_tpu_torch.compile_pattern(pattern, device=None)
    assert sc.precompile(len(data), sample=data[:1 << 20] if fused
                         else b"") > 0
    assert sc.count(data) == host.count(data)
    assert sc.stats().tier == ("CoreTables" if fused else "SpecTablesPair")


# ---------------------------------------------------------------------
# the mesh: four shards of the one card (a virtual mesh, on the route of
# distinct devices: each shard's blocks and planes its own tensors)
# ---------------------------------------------------------------------

def _all_scan_launches():
    """Launches of every static tier's scan kernels."""
    return (_spec_launches() + tbig.big_scan_launches
            + tbig.big_smem_launches + taff.affine_scan_launches)


def _mesh_tables(cuda, tier):
    """(tables, corpus alphabet, planted word) of one tier on the card."""
    import sregex_tpu_torch
    if tier == "narrow":
        sc = sregex_tpu_torch.compile_pattern(
            "(?:a|b)aa(?:aa|bb)cc(?:a|b)", device=None)
        return tscan.SpecTables(sc.dfa, cuda), b"abccc x", b"xaaabbccb"
    if tier == "affine":
        sc = sregex_tpu_torch.compile_pattern("a{60,120}b", device=None)
        return taff.SpecTablesAffine(sc.dfa, cuda), b"aaaab x", \
            b"x" + b"a" * 90 + b"b"
    words = _dictionary(60 if tier == "wide" else 400, 3)
    sc = sregex_tpu_torch.compile_pattern(words, device=None)
    cls = tscan.SpecTablesWide if tier == "wide" else tbig.SpecTablesBig
    return cls(sc.dfa, cuda), b"abcdefghijklmnopqrstuvwxyz ", \
        b" " + words[7] + b" "


@pytest.mark.parametrize("tier", ["narrow", "wide", "big", "affine"])
def test_sharded_dispatch_on_a_virtual_mesh_equals_one_device(cuda, tier):
    """Four shards of one card: each tier's summary and planes over a
    64 MB corpus (four block rows, one a shard) are bit-identical to one
    launch over the whole prep, and each shard launched once; the counts
    equal the native engine's over meshes of 4 and 2 shards."""
    from sregex_tpu_torch.native import NativeDfa
    from sregex_tpu_torch.ops.mesh import Mesh
    from sregex_tpu_torch.ops.prep import prepare_auto
    tables, alpha, word = _mesh_tables(cuda, tier)
    rng = np.random.default_rng(7)
    text = rng.choice(np.frombuffer(alpha, np.uint8), 64 << 20)
    for at in rng.integers(0, len(text) - 200, 50):
        text[at:at + len(word)] = np.frombuffer(word, np.uint8)
    data = text.tobytes()
    mesh = Mesh([cuda] * 4)
    d, C, K, J, B = prepare_auto(tables, data, 2048, mesh=mesh)
    whole = prepare_auto(tables, data, 2048, b_multiple=4)
    assert B == 4 and whole[1:] == (C, K, J, B)
    s0, j0 = tscan._entry_planes(0, tables.warmup, B, cuda)
    bad = (C - 1) if C * K > len(data) else -1
    one = tables._scan(whole[0], s0, j0, C, bad, tables.warmup, COUNT=True)
    before = _all_scan_launches()
    got = tables._scan(d, s0, j0, C, bad, tables.warmup, COUNT=True,
                       mesh=mesh)
    torch.cuda.synchronize()
    assert _all_scan_launches() == before + 4
    assert torch.equal(one[0], got[0]) and torch.equal(one[1], got[1])
    want = NativeDfa(tables.dfa).count(data, 0)[::-1]
    for m in (mesh, Mesh([cuda] * 2)):
        st, k = tscan.spec_count_bytes(tables, data, mesh=m)
        assert (st, k) == want


def test_fused_mesh_on_a_virtual_mesh_equals_one_device(cuda):
    """The fused two-phase count of the 400-keyword dictionary over four
    shards of one card: the merged and core planes are bit-identical to
    one device's (escapes in every shard, under each shard's cap), one
    gated launch a shard, and the count equals the native engine's."""
    from sregex_tpu_torch.native import NativeDfa
    from sregex_tpu_torch.ops import core as tcore
    from sregex_tpu_torch.ops.mesh import Mesh
    tables, _, _ = _mesh_tables(cuda, "big")
    words = _dictionary(400, 3)
    rng = np.random.default_rng(9)
    filler = np.frombuffer(b"nopqrstuvwxyz ", np.uint8)
    text = rng.choice(filler, 64 << 20)
    for i, at in enumerate(rng.integers(0, len(text) - 200, 4000)):
        w = b" " + words[i % len(words)] + b" "
        text[at:at + len(w)] = np.frombuffer(w, np.uint8)
    data = text.tobytes()
    # a core sampled from the filler alone: the planted words escape
    sample = rng.choice(filler, 1 << 20).tobytes()
    ct = tcore.CoreTables(tables.dfa, sample, require_fast=False,
                          no_pair=True, prefer_small=True,
                          max_escape_frac=tcore.FUSED_ESCAPE_FRAC,
                          device=cuda)
    mesh = Mesh([cuda] * 4)
    one = tcore._fused_dispatch(ct, tables, data, 2048, 0, None, None)
    g0 = tcore.gated_scan_launches
    got = tcore._fused_dispatch(ct, tables, data, 2048, 0, None, None,
                                mesh=mesh)
    assert tcore.gated_scan_launches == g0 + 4
    assert (got["shard_summ"][:, 8] > 0).all() and not one["summ"][7]
    live = one["Cfull"]
    for key in ("merged", "packed_core"):
        assert torch.equal(one[key][:, :live], got[key][:, :live]), key
    assert np.array_equal(one["summ"][5:], got["summ"][5:])
    want = NativeDfa(tables.dfa).count(data, 0)[::-1]
    assert tcore.core_count_fused(ct, tables, data, mesh=mesh) == want
    assert tcore.core_count_fused(ct, tables, data,
                                  mesh=Mesh([cuda] * 2)) == want


def test_scanner_on_a_virtual_mesh_runs_on_the_card(cuda):
    """Scanner(mesh=) on four shards of the card: count, scan,
    count_many and count_stream equal the one-device Scanner and the
    native engine, and the two-code kernel ran once a shard a scan; on
    meshes of 4 and 2 shards."""
    import sregex_tpu_torch
    from sregex_tpu_torch.ops.mesh import Mesh
    pattern = "(?:a|b)aa(?:aa|bb)cc(?:a|b)"
    rng = np.random.default_rng(13)
    text = rng.choice(np.frombuffer(b"abccc x", np.uint8), 40 << 20)
    text[(30 << 20):(30 << 20) + 9] = np.frombuffer(b"xaaabbccb", np.uint8)
    data = text.tobytes()
    docs = [data[i:i + (3 << 20)] for i in range(0, len(data), 3 << 20)]
    segs = [data[i:i + (16 << 20)] for i in range(0, len(data), 16 << 20)]
    one = sregex_tpu_torch.compile_pattern(pattern)
    want = (one.count(data), one.scan(data), one.count_many(docs),
            one.count_stream(segs))
    host = sregex_tpu_torch.compile_pattern(pattern, device=None)
    assert want[:2] == (host.count(data), host.scan(data))
    for mesh in (Mesh([cuda] * 4), Mesh([cuda] * 2)):
        sc = sregex_tpu_torch.compile_pattern(pattern, mesh=mesh)
        before = tscan.pair_scan_launches
        assert sc.count(data) == want[0]
        assert tscan.pair_scan_launches == before + mesh.size
        assert (sc.scan(data), sc.count_many(docs),
                sc.count_stream(segs)) == want[1:]


@pytest.mark.parametrize("pattern,plant", [
    (rb"(foo|bar|baz|qux)=[0-9a-f]{2,8}", b"foo=1a2b"),
    (rb"(GET|POST|PUT|HEAD) /[a-z]{1,12}\.(html|php|js)",
     b"GET /index.html")])
def test_tier_ab_runs_on_the_card(cuda, monkeypatch, pattern, plant):
    """A mid-band wide machine (4 rows: the fast legacy core's arm; 6
    rows: the fused core's) on the card with SREGEX_TIER_AB=1: the first
    count is served by the core and times it against the static tier,
    tier_ab records the arms, count_many follows the winner, and every
    count, the winner's included, equals the native engine's."""
    import sregex_tpu_torch
    from sregex_tpu_torch import stream as tstream
    monkeypatch.setenv("SREGEX_TIER_AB", "1")
    sc = sregex_tpu_torch.compile_pattern(pattern)
    assert tstream._core_band(sc._spec) == "ab"
    n = 24 << 20
    unit = b"0123 456 789 -- 01 2345 "
    text = bytearray((unit * (n // len(unit) + 1))[:n])
    # plants outside the core's four sample slices, so that it builds
    for pos in range(300_000, n - 64, 1 << 20):
        text[pos:pos + len(plant)] = plant
    data = bytes(text)
    host = sregex_tpu_torch.compile_pattern(pattern, device=None)
    want = host.count(data)
    assert want > 0
    assert sc.count(data) == want
    assert sc.stats().tier == "CoreTables"
    ab = sc.tier_ab
    assert ab["bytes"] == n and ab["static_s"] > 0 and ab["core_s"] > 0
    assert ab["core_arm"] == ("_coret" if sc._spec.rows <= 4
                              else "_fusedct")
    for _ in range(2):
        assert sc.count(data) == want
    assert sc.scan(data) == host.scan(data)
    # the batch path runs no A/B and follows its winner
    docs = [data[i:i + (1 << 20)] for i in range(0, n, 1 << 20)]
    assert sc.count_many(docs) == [host.count(d) for d in docs]
    assert sc.stats().tier == ("SpecTablesWide" if ab["winner"] == "static"
                               else "CoreTables")
