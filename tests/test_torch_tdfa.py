"""The port's tagged-DFA tier (ops/tdfa_scan.py) against the JAX
package's (ops/tdfa_scan.py, the Pallas kernel in interpret mode on the
CPU mesh, as its own tests run it).

Tables: for the patterns of tests/test_tdfa_device.py (CASES,
WIDE_CASES, the 8-bit-class, byte-code and 16-bit-code patterns) both
packages build the same tagged DFA and the same code planes, and
convert.tdfa_tables_from_jax carries the JAX planes over unchanged.
Kernel: on identical seeded inputs, tdfa_scan_ref (which the wrapper
takes for CPU tensors) gives the JAX kernel's phi, swarm, bank and regs
planes and the same device summary, for 4-, 8- and 16-bit codes, one
and several table rows, 4- and 8-bit class words, and random tables
whose codes reach every source kind (registers, ids past R, UNSET,
CUR, NEXT).  Every quantity is an integer: the tolerance is exact
equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sregex_tpu
from sregex_tpu.ops import tdfa_scan as jtdfa
from sregex_tpu.tdfa import TdfaTooLarge as JaxTdfaTooLarge

import sregex_tpu_torch
from sregex_tpu_torch import convert
from sregex_tpu_torch.ops import tdfa_scan as ttdfa
from sregex_tpu_torch.ops.layout import GROUPS, TILE
from sregex_tpu_torch.tdfa import TdfaTooLarge

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


CPU = torch.device("cpu")

EIGHT_BIT_PAT = rb"(money|parted|fool|kilo|victor|zebra)x([0-9]+)"
BYTECODE_PAT = rb"(\d+)-(\d+)-(\d+)T(\d+):(\d+):(\d+)\.(\d+)"
SIXTEEN_PAT = "x(a+)(b)(c)(d)(e)(f)(g)(h)(i)(j)(k)(l)(m)(n)(o)(p+)y"

# name -> (pattern, SREGEX_TDFA_MAX or None); tests/test_tdfa_device.py
# CASES and WIDE_CASES, then its 8-bit, byte-code and 16-bit patterns
PATTERNS = {
    "ab+c": ("ab+c", None),
    "a+b+c?": ("(a+)(b+)c?", None),
    "multi": (["foo", "ba(r+)"], None),
    "caret": ("^x", None),
    "word-b": ("q\\b", None),
    "dollar": ("z$", None),
    "five-groups": ("(\\d+)-(\\d+)-(\\d+) (\\w+):(\\w+)", None),
    "four-groups": ("(\\w+)=(\\w+);(\\w+)=(\\w+)", None),
    "wide-foo": (rb"(foo|bar)(baz|qux)x", None),
    "wide-get": (rb"(GET|POST|PUT)x(HTTP|FTP)", None),
    "8bit": (EIGHT_BIT_PAT, 4096),
    "bytecode": (BYTECODE_PAT, None),
    "16bit": (SIXTEEN_PAT, None),
    "log-fields": (rb"status=([0-9]+) user=([a-z_]+)", None),
}

FIELDS = ("nstates", "nregs", "ntags", "ncls", "code_bits", "rows", "bits",
          "cpw", "warmup", "seed_premult", "dead_premult", "tags")


def _programs(pat):
    return (sregex_tpu.compile_pattern(pat).program,
            sregex_tpu_torch.compile_pattern(pat, device=None).program)


def _flat(a):
    """A JAX plane [rows, 8, 128] or stack [P, rows, 8, 128] -> the
    port's [rows*128] / [P, rows*128] (every row is sublane-broadcast)."""
    a = np.asarray(a)
    assert (a == a[..., :1, :]).all()
    return a[..., 0, :].reshape(a.shape[:-3] + (-1,))


def _jax_arrays(jt):
    out = {k: getattr(jt, k) for k in convert._TDFA_FIELDS}
    out["tags"] = jt.tags
    for k in ("t_next", "t_regsrc", "t_csrc", "t_cmeta"):
        out[k] = np.asarray(getattr(jt, k)).copy()
    return out


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_tables_and_planes_equal_the_jax_tables(name, monkeypatch):
    pat, tmax = PATTERNS[name]
    if tmax:
        monkeypatch.setenv("SREGEX_TDFA_MAX", str(tmax))
    jprog, tprog = _programs(pat)
    try:
        jt = jtdfa.TdfaSpecTables(jprog)
    except JaxTdfaTooLarge:
        with pytest.raises(TdfaTooLarge):
            ttdfa.TdfaSpecTables(tprog, CPU)
        return
    tt = ttdfa.TdfaSpecTables(tprog, CPU)
    for f in FIELDS:
        assert getattr(tt, f) == getattr(jt, f), f
    assert np.array_equal(tt.class_map, jt.class_map)
    for k in ("t_next", "t_regsrc", "t_csrc", "t_cmeta"):
        assert np.array_equal(getattr(tt, k).numpy(),
                              _flat(getattr(jt, k))), k
    ct = convert.tdfa_tables_from_jax(_jax_arrays(jt), tprog, CPU)
    for k in ("t_next", "t_regsrc", "t_csrc", "t_cmeta"):
        assert torch.equal(getattr(ct, k), getattr(tt, k)), k


def test_code_widths_and_budget_decline_as_the_jax_package():
    """4-bit codes up to 13 regs/tags, byte codes past it, 16-bit codes
    past 24; the CPU budget of 512 entries declines what the JAX
    package's interpret-mode budget declines, SREGEX_TDFA_MAX lifts it,
    and the card's budget is the TPU's 2048."""
    _, p8 = _programs(BYTECODE_PAT)
    t8 = ttdfa.TdfaSpecTables(p8, CPU)
    assert (t8.code_bits, t8.ntags, t8.t_csrc.shape[0]) == (8, 16, 4)
    _, p16 = _programs(SIXTEEN_PAT)
    t16 = ttdfa.TdfaSpecTables(p16, CPU)
    assert (t16.code_bits, t16.ntags, t16.t_csrc.shape[0]) == (16, 34, 17)
    _, pe = _programs(EIGHT_BIT_PAT)
    with pytest.raises(TdfaTooLarge):
        ttdfa.TdfaSpecTables(pe, CPU)
    assert ttdfa._tdfa_max(torch.device("cuda")) == 2048
    assert ttdfa._tdfa_max(CPU) == 512


def _bc(flat, rows):
    """Port plane(s) [..., rows*128] -> the JAX layout [..., rows, 8, 128]."""
    r = flat.reshape(flat.shape[:-1] + (rows, 128))
    return jnp.asarray(np.ascontiguousarray(np.broadcast_to(
        r[..., None, :], r.shape[:-1] + (8, 128))))


def _random_tables(rng, rows, ncls, code, R, T):
    """Random flat planes: valid premultiplied next states, commits on
    about a third of the entries with random ids, and code slots that
    are register ids (up to two past R) or UNSET, CUR and NEXT."""
    n = rows * 128
    S = n // ncls
    spp = 32 // code
    t_next = (rng.integers(0, S, n) * ncls).astype(np.int32)
    commit = rng.random(n) < 0.3
    t_cmeta = np.where(commit, 1 | (rng.integers(0, 128, n) << 1),
                       rng.integers(0, 1 << 20, n) << 1).astype(np.int32)

    top = (1 << code) - 1
    kinds = np.array([top - 2, top - 1, top], np.uint64)   # UNSET CUR NEXT

    def words(k):
        # half the slots a register id (two past R), half a special
        P = max(1, -(-k // spp))
        slots = np.where(rng.random((P, spp, n)) < 0.5,
                         rng.integers(0, R + 2, (P, spp, n)),
                         kinds[rng.integers(0, 3, (P, spp, n))])
        out = np.zeros((P, n), np.uint64)
        for sl in range(spp):
            out |= slots[:, sl].astype(np.uint64) << np.uint64(code * sl)
        return out.astype(np.uint32).view(np.int32)

    return t_next, words(R), words(T), t_cmeta


def _pattern_tables(pat, tmax, monkeypatch):
    if tmax:
        monkeypatch.setenv("SREGEX_TDFA_MAX", str(tmax))
    _, tprog = _programs(pat)
    tt = ttdfa.TdfaSpecTables(tprog, CPU)
    return ((tt.t_next.numpy(), tt.t_regsrc.numpy(), tt.t_csrc.numpy(),
             tt.t_cmeta.numpy()), tt.ncls, tt.code_bits, tt.bits,
            tt.nregs, tt.ntags, tt.rows, tt.dead_premult)


# name -> pattern tables, or (rows, ncls, CODE, BITS, R, T) for random
# tables, R and T at the edge of the 4- and 8-bit code widths.  The
# 16-bit edge, 48, is held against the plain version on the card
# (tests/test_torch_cuda.py, chip_smoke.py): the interpret-mode JAX
# kernel's resolve chains grow with R * R, and its compile time with
# them (about half a minute already at R = 20, T = 30).
KERNEL_CASES = {
    "pattern-code4-rows1": ("(a+)(b+)c?", None),
    "pattern-code4-rows2": (rb"(foo|bar)(baz|qux)x", None),
    "pattern-code8-rows1": (BYTECODE_PAT, None),
    "pattern-code16-rows4-8bit": (SIXTEEN_PAT, None),
    "pattern-code4-8bit": (EIGHT_BIT_PAT, 4096),
    "random-code4-edge": (1, 8, 4, 4, 13, 13),
    "random-code8-edge-8bit": (3, 40, 8, 8, 24, 24),
    "random-code16-rows2": (2, 16, 16, 4, 10, 14),
}
# Each case compiles its own interpret-mode JAX program (its code width,
# R, T and rows are static), so the cases are shared out between this
# file, tests/test_torch_tdfa_kernel.py and tests/test_torch_tdfa_edges.py
# to balance the test workers.
KERNEL_CASES_KERNEL_FILE = ("pattern-code8-rows1", "random-code8-edge-8bit")
KERNEL_CASES_EDGES_FILE = ("pattern-code4-8bit", "random-code4-edge",
                           "random-code16-rows2")


@pytest.mark.parametrize("name", sorted(set(KERNEL_CASES)
                                        - set(KERNEL_CASES_KERNEL_FILE)
                                        - set(KERNEL_CASES_EDGES_FILE)))
def test_planes_and_summary_match_jax(name, monkeypatch):
    planes_and_summary_match_jax(name, monkeypatch)


def planes_and_summary_match_jax(name, monkeypatch):
    """KERNEL_CASES[name] through the JAX kernel and the port's plain
    version on identical seeded inputs: planes and summary equal."""
    rng = np.random.default_rng(sum(map(ord, name)))
    case = KERNEL_CASES[name]
    if name.startswith("pattern"):
        tabs, ncls, code, bits, R, T, rows, dead = _pattern_tables(
            *case, monkeypatch)
        cls_hi = ncls                     # classes the prep can produce
    else:
        rows, ncls, code, bits, R, T = case
        tabs = _random_tables(rng, rows, ncls, code, R, T)
        cls_hi = 1 << bits                # past the table too
        dead = int(tabs[0][5])
    cpw = 32 // bits
    W = 4 * cpw
    K = 64
    Jw = (W + K) // cpw
    B = 1
    cls = rng.integers(0, cls_hi, (B, Jw, GROUPS, 8, 128, cpw),
                       dtype=np.int64)
    words = np.zeros(cls.shape[:-1], np.int64)
    for k in range(cpw):
        words |= cls[..., k] << (bits * k)
    data = words.astype(np.uint32).view(np.int32)
    S = rows * 128 // ncls
    state0 = (rng.integers(0, S, (B, GROUPS, 8, 128)) * ncls) \
        .astype(np.int32)
    j0 = rng.integers(0, W + 1, (B, GROUPS, 8, 128)).astype(np.int32)
    j0[0, 0, 0, 0] = W                    # a true-entry stream
    Cp = B * GROUPS * TILE
    C = Cp - 3
    if name.startswith("pattern"):
        # plant a dead exit state in some streams' entries
        dead = dead if dead >= 0 else int(tabs[0][0])
    jout = jtdfa._tdfa_scan(
        jnp.asarray(data), jnp.asarray(state0), jnp.asarray(j0),
        _bc(tabs[0], rows), _bc(tabs[1], rows), _bc(tabs[2], rows),
        _bc(tabs[3], rows), jnp.int32(C), jnp.int32(dead),
        J=W + K, W=W, CPW=cpw, BITS=bits, CODE=code, R=R, T=T, ROWS=rows)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (data, state0, j0, *tabs)]
    before = ttdfa.tdfa_scan_launches
    planes = ttdfa.tdfa_scan(*t, W=W, CPW=cpw, BITS=bits, CODE=code, R=R,
                             T=T)
    assert ttdfa.tdfa_scan_launches == before      # the plain version ran
    tout = ttdfa._summarize(*planes, t[1], C, dead)
    for j, g, what in zip(jout, tout, ("summary", "phi", "swarm", "bank",
                                       "regs")):
        assert np.array_equal(np.asarray(j), g.numpy()), what
    if name.startswith("random"):
        # the cases reach committed banks, UNSET and real positions
        bank, regs = planes[2], planes[3]
        assert (bank[T] >= 0).any() and (bank[:T] >= 0).any()
        assert (regs >= 0).any() and (regs == -1).any()


def test_wrapper_checks_and_never_falls_back_for_non_cpu_tensors():
    B, G, Jw = 1, 1, 20
    data = torch.zeros((B, Jw, G, 8, 128), dtype=torch.int32)
    s = torch.zeros((B, G, 8, 128), dtype=torch.int32)
    tab = torch.zeros(128, dtype=torch.int32)
    planes = torch.zeros((1, 128), dtype=torch.int32)
    kw = dict(W=32, CPW=8, BITS=4, CODE=4, R=3, T=2)
    phi, swarm, bank, regs = ttdfa.tdfa_scan(data, s, s, tab, planes,
                                             planes, tab, **kw)
    assert bank.shape == (3, B, G, 8, 128) and regs.shape == (3, B, G, 8,
                                                              128)
    for bad in (dict(CODE=5), dict(R=14), dict(T=14), dict(BITS=3, CPW=10),
                dict(W=36)):
        with pytest.raises(ValueError):
            ttdfa.tdfa_scan(data, s, s, tab, planes, planes, tab,
                            **{**kw, **bad})
    with pytest.raises(ValueError, match="t_regsrc"):
        ttdfa.tdfa_scan(data, s, s, tab, planes, planes, tab,
                        **{**kw, "CODE": 8, "R": 9})
    with pytest.raises(TypeError):
        ttdfa.tdfa_scan(data.to(torch.int64), s, s, tab, planes, planes,
                        tab, **kw)
    meta = [x.to("meta") for x in (data, s, s, tab, planes, planes, tab)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ttdfa.tdfa_scan(*meta, **kw)
