"""The corpus generator: seeded, sized, distinct answers over a ring,
and fasta's own letters."""

from portbench import gen, harness, reference

CONFIG = harness.load_json(harness.HERE / "configs" / "regex-redux.json")


def test_seeded_sized_distinct():
    mod = harness.load_module(harness.HERE / "gen" / "fasta.py")
    ref = harness.load_module(harness.HERE / "configs" / "regex-redux.py")
    n = 1 << 20
    a = mod.make_ring(CONFIG["params"], n, 4, 2 ** 31 + 5)
    b = mod.make_ring(CONFIG["params"], n, 4, 2 ** 31 + 5)
    c = mod.make_ring(CONFIG["params"], n, 4, 2 ** 31 + 6)
    assert a == b and a != c
    assert all(len(s) == n for s in a)
    ans = [reference.answers(ref, s, "cpu") for s in a]
    assert len({x.count for x in ans}) == 4
    # fasta's sections: the ALU (upper case, so no variant), then the
    # IUB and Homo sapiens letters; about one match in 2,500 bytes
    alu = set(CONFIG["params"]["alu"].encode())
    assert all(set(s[:n // 5]) <= alu for s in a)
    assert all(x.first > n // 5 and 100 < x.count < 2000 for x in ans)


def test_fasta_follows_its_generator():
    """A shard started at fasta's own state (42) and the ALU's first
    letter holds fasta's letters: the ALU repeated, then each draw of
    the generator, last = (last * IA + IC) % IM, looked up in the IUB
    table and then the Homo sapiens table by r < cumulative p."""
    prm = CONFIG["params"]
    mod = harness.load_module(harness.HERE / "gen" / "fasta.py")

    def pick(table, r):
        cum = 0.0
        for c, p in table:
            cum += p
            if r < cum:
                return ord(c)
        return ord(table[-1][0])

    n = 10000
    arr = mod.np.zeros(n, mod.np.uint8)
    gen.fill(arr[:2000], mod.np.frombuffer(prm["alu"].encode(), "u1"), 0)
    states = mod._cycle(prm["im"], prm["ia"], prm["ic"], prm["start"])
    iub = mod._letters(prm["iub"], states / prm["im"])
    homo = mod._letters(prm["homosapiens"], states / prm["im"])
    gen.fill(arr[2000:5000], iub, 1)
    gen.fill(arr[5000:], homo, 3001 % prm["im"])
    last, want = prm["start"], []
    for i in range(8000):
        last = (last * prm["ia"] + prm["ic"]) % prm["im"]
        want.append(pick(prm["iub"] if i < 3000 else prm["homosapiens"],
                         last / prm["im"]))
    assert bytes(arr[:2000]) == (prm["alu"].encode() * 7)[:2000]
    assert list(arr[2000:]) == want
