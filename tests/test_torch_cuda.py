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
