// Native tagged-DFA walker: the findall/finditer hot loop at
// table-walk speed.
//
// The host Tdfa (tdfa.py) determinizes one Pike step per
// (state, byte-class) into: next state, a register rebuild (each new
// register = old register | current pos | next pos), and at most one
// commit (bank = resolved tag vector + regex id) — the same dataflow
// the Pallas kernel vectorizes (ops/tdfa_scan.py).  This walker runs
// the whole re-arm loop (sre_vm_pike.c:624-635) over a buffer: seed,
// step until the dead state, emit the committed bank, re-seed at the
// match end (one-byte skip after an empty match, :179-194), repeat.
//
// Seeds take their prev-byte context from the ACTUAL predecessor byte
// (exact-mode semantics: true leftmost-first, no stale-carry quirks —
// see docs/CONFORMANCE.md quirks #3/#4); this matches the exact-mode
// Pike engines that define the Scanner API's behavior.
//
// Tables are materialized dense by native_tdfa.py; budgets
// there bound S*ncls, registers and tags, so every array here is a
// flat C array and the per-byte cost is one row load + a tiny
// register loop.

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

inline int isword(uint8_t c) {
    return (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z')
        || (c >= 'a' && c <= 'z') || c == '_';
}

// source codes (native_tdfa.py must agree)
const int8_t SRC_UNSET = -1;
const int8_t SRC_CUR = -2;
const int8_t SRC_NEXT = -3;

struct Tables {
    int32_t S, ncls, Rmax, T, nregexes;
    const int32_t* next_sid;     // [S*ncls]
    const int8_t* op_src;        // [S*ncls, Rmax]
    const int16_t* commit_rid;   // [S*ncls] (-1 = none)
    const int8_t* commit_src;    // [S*ncls, T]
    const int16_t* eof_rid;      // [S] (-1 = none)
    const int8_t* eof_src;       // [S, T]
    const uint8_t* dead;         // [S]
    const int8_t* nregs;         // [S]
    const int32_t* seed_sid;     // [5] by prev-byte context
    const uint8_t* class_map;    // [256]
    const int32_t* slice_ofs;    // [nregexes]
    // owned copies
    void* blob;

    // seed-family prefilter: while the walk sits in a seed state with
    // no pending bank, bytes that neither commit nor leave the family
    // only advance the implicit ".*?" position — skip them in a tight
    // loop (the table-walk analogue of the Pike leading-byte memchr,
    // sre_vm_pike.c:992-1061).  A byte is skippable ONLY when, from
    // EVERY seed state, its transition (a) commits nothing, (b) lands
    // in the SAME family state (skip_succ[b]), and (c) rebuilds every
    // register as SRC_NEXT (position-following).  Then the skip loop
    // reproduces the table walk EXACTLY: the end state is
    // skip_succ[last byte] and every register equals the position —
    // no behavioral-equivalence assumption about seeds is needed.
    // (A transition that keeps a register — e.g. the t0 of a ``b*``
    // prefix whose progress state dedups onto a seed id — fails (c)
    // and stays interesting: skipping it would lose an earlier
    // leftmost match start.)
    uint8_t is_family[4096];     // indexed by sid (S <= 4096 here)
    uint8_t interesting[256];
    int16_t skip_succ[256];      // walked successor of a skip byte
    int single_byte;             // the one interesting byte, or -1
};

inline int ctx_of(uint8_t prev) {
    return 1 + (isword(prev) ? 1 : 0) + (prev == '\n' ? 2 : 0);
}

inline int64_t res(int8_t s, const int64_t* regs, int64_t cur,
                   int64_t nxt) {
    if (s >= 0) return regs[s];
    if (s == SRC_UNSET) return -1;
    if (s == SRC_CUR) return cur;
    return nxt;                     // SRC_NEXT
}

}  // namespace

extern "C" {

void* sre_tdfa_create(int32_t S, int32_t ncls, int32_t Rmax, int32_t T,
                      int32_t nregexes,
                      const int32_t* next_sid, const int8_t* op_src,
                      const int16_t* commit_rid,
                      const int8_t* commit_src,
                      const int16_t* eof_rid, const int8_t* eof_src,
                      const uint8_t* dead, const int8_t* nregs,
                      const int32_t* seed_sid,
                      const uint8_t* class_map,
                      const int32_t* slice_ofs) {
    Tables* t = new Tables();
    t->S = S; t->ncls = ncls; t->Rmax = Rmax; t->T = T;
    t->nregexes = nregexes;
    size_t sc = (size_t) S * ncls;
    size_t sz = sc * 4 + sc * Rmax + sc * 2 + sc * T
        + (size_t) S * 2 + (size_t) S * T + S + S + 5 * 4 + 256
        + (size_t) nregexes * 4 + 64;
    char* b = (char*) malloc(sz);
    t->blob = b;
    char* p = b;
    auto put = [&](const void* src, size_t n) {
        memcpy(p, src, n);
        void* r = p;
        p += (n + 7) & ~(size_t) 7;
        return r;
    };
    t->next_sid = (int32_t*) put(next_sid, sc * 4);
    t->op_src = (int8_t*) put(op_src, sc * Rmax);
    t->commit_rid = (int16_t*) put(commit_rid, sc * 2);
    t->commit_src = (int8_t*) put(commit_src, sc * T);
    t->eof_rid = (int16_t*) put(eof_rid, (size_t) S * 2);
    t->eof_src = (int8_t*) put(eof_src, (size_t) S * T);
    t->dead = (uint8_t*) put(dead, S);
    t->nregs = (int8_t*) put(nregs, S);
    t->seed_sid = (int32_t*) put(seed_sid, 5 * 4);
    t->class_map = (uint8_t*) put(class_map, 256);
    t->slice_ofs = (int32_t*) put(slice_ofs, (size_t) nregexes * 4);

    memset(t->is_family, 0, sizeof(t->is_family));
    for (int c = 0; c < 5; c++)
        if (seed_sid[c] >= 0 && seed_sid[c] < 4096)
            t->is_family[seed_sid[c]] = 1;
    memset(t->interesting, 0, sizeof(t->interesting));
    for (int b = 0; b < 256; b++) {
        int cls = class_map[b];
        int32_t succ = -1;
        bool skippable = true;
        for (int c = 0; c < 5 && skippable; c++) {
            int32_t sid = seed_sid[c];
            int64_t idx = (int64_t) sid * ncls + cls;
            int32_t ns = t->next_sid[idx];
            if (t->commit_rid[idx] >= 0 || ns >= 4096
                    || !t->is_family[ns]
                    || (succ >= 0 && ns != succ)) {
                skippable = false;
                break;
            }
            succ = ns;
            int nk = t->nregs[ns];
            const int8_t* os = t->op_src + idx * Rmax;
            for (int d = 0; d < nk; d++)
                if (os[d] != SRC_NEXT) { skippable = false; break; }
        }
        t->interesting[b] = skippable ? 0 : 1;
        t->skip_succ[b] = skippable ? (int16_t) succ : -1;
    }
    t->single_byte = -1;
    int cnt = 0;
    for (int b = 0; b < 256; b++)
        if (t->interesting[b]) { cnt++; t->single_byte = b; }
    if (cnt != 1) t->single_byte = -1;
    return t;
}

void sre_tdfa_destroy(void* h) {
    Tables* t = (Tables*) h;
    free(t->blob);
    delete t;
}

// Emit up to max_matches matches of data[start_pos:] into out
// (row-major [max_matches, 1 + T]: regex id then the tag vector,
// absolute positions).  empty_skip: the previous match (before
// start_pos) was empty — apply the one-byte skip.  Returns the number
// of matches written; == max_matches means possibly more (resume with
// start_pos = end of the last match, empty_skip = it was empty).
int64_t sre_tdfa_findall(void* h, const uint8_t* data, int64_t n,
                         int64_t start_pos, int32_t empty_skip,
                         int64_t* out, int64_t max_matches) {
    Tables* tb = (Tables*) h;
    const int32_t ncls = tb->ncls;
    const int32_t T = tb->T;
    const int32_t Rmax = tb->Rmax;
    int64_t regs_a[128], regs_b[128], bank[128];
    int64_t* regs = regs_a;
    int64_t* regs2 = regs_b;
    int64_t pos = start_pos;
    int64_t nm = 0;
    int skip = empty_skip != 0;

    while (nm < max_matches) {
        int64_t sp = pos;
        int ctx;
        if (skip) {
            if (pos >= n) break;
            sp = pos + 1;
            ctx = ctx_of(data[pos]);
            skip = 0;
        } else {
            ctx = (sp == 0) ? 0 : ctx_of(data[sp - 1]);
        }
        int32_t sid = tb->seed_sid[ctx];
        int k = tb->nregs[sid];
        for (int d = 0; d < k; d++) regs[d] = sp;
        int64_t bank_rid = -1;
        int64_t i = sp;
        bool died = false;

        while (i < n) {
            if (bank_rid < 0 && tb->is_family[sid]) {
                // seed-family prefilter: skip to the next byte that
                // can commit or leave the family, then re-seed there
                int64_t j = i;
                if (tb->single_byte >= 0) {
                    const void* f = memchr(data + j,
                                           tb->single_byte, n - j);
                    j = f ? (const uint8_t*) f - data : n;
                } else {
                    const uint8_t* interesting = tb->interesting;
                    while (j < n && !interesting[data[j]]) j++;
                }
                if (j > i) {
                    i = j;
                    // the skipped walk's exact end state: skippable
                    // bytes have a seed-independent successor and
                    // position-following registers
                    sid = tb->skip_succ[data[i - 1]];
                    int nk = tb->nregs[sid];
                    for (int d = 0; d < nk; d++) regs[d] = i;
                    if (i >= n) break;
                }
            }
            int cls = tb->class_map[data[i]];
            int64_t idx = (int64_t) sid * ncls + cls;
            int64_t cur = i, nxt = i + 1;
            int16_t crid = tb->commit_rid[idx];
            if (crid >= 0) {
                const int8_t* cs = tb->commit_src + idx * T;
                for (int t = 0; t < T; t++)
                    bank[t] = res(cs[t], regs, cur, nxt);
                bank_rid = crid;
            }
            int32_t ns = tb->next_sid[idx];
            int nk = tb->nregs[ns];
            const int8_t* os = tb->op_src + idx * Rmax;
            for (int d = 0; d < nk; d++)
                regs2[d] = res(os[d], regs, cur, nxt);
            int64_t* tmp = regs; regs = regs2; regs2 = tmp;
            sid = ns;
            i++;
            if (tb->dead[sid]) { died = true; break; }
        }
        if (!died) {
            // EOF boundary (sre_vm_pike.c one extra iteration)
            int16_t erid = tb->eof_rid[sid];
            if (erid >= 0) {
                const int8_t* cs = tb->eof_src + (int64_t) sid * T;
                for (int t = 0; t < T; t++)
                    bank[t] = res(cs[t], regs, n, n);
                bank_rid = erid;
            }
        }
        if (bank_rid < 0) break;        // no further match
        int64_t* row = out + nm * (1 + T);
        row[0] = bank_rid;
        for (int t = 0; t < T; t++) row[1 + t] = bank[t];
        nm++;
        int32_t ofs = tb->slice_ofs[bank_rid];
        int64_t ms = bank[ofs], me = bank[ofs + 1];
        if (ms == me) {
            if (me >= n) break;         // empty match at EOF: stop
            skip = 1;
        }
        pos = me;
    }
    return nm;
}

}  // extern "C"
