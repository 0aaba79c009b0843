// Native streaming Pike VM for sregex-tpu.
//
// The production host engine: full streaming matching with sub-match
// captures and multi-regex IDs, behaviorally equivalent to the Python
// engine pike_vm.py (itself verified byte-for-byte against
// the reference sre_vm_pike.c on the whole conformance corpus).
// Implements the same semantics: leftmost-first priority via ordered
// thread lists, tag-based dedup with the split-y retry quirk,
// copy-on-write refcounted captures, postponed lookahead assertions
// spliced at the front of the current list, the empty-match re-arm
// protocol, seen_word/seen_newline carries, pending/temp captures,
// and the leading-bytes prefilter.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

enum {
    OP_CHAR = 1, OP_MATCH = 2, OP_JMP = 3, OP_SPLIT = 4, OP_ANY = 5,
    OP_SAVE = 6, OP_IN = 7, OP_NOTIN = 8, OP_ASSERT = 9
};

enum {
    A_SMALL_Z = 0x01, A_DOLLAR = 0x02, A_BIG_B = 0x04, A_SMALL_B = 0x08,
    A_BIG_A = 0x10, A_CARET = 0x20
};

enum { RC_OK = 0, RC_ERROR = -1, RC_AGAIN = -2, RC_DONE = -4,
       RC_DECLINED = -5 };

static inline bool isword(uint8_t c) {
    return (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z')
        || (c >= 'a' && c <= 'z') || c == '_';
}

struct Inst {
    int32_t opcode;
    int32_t x, y;
    int32_t val;            // ch | group | assertion | regex_id
    int32_t range_ofs;
    int32_t range_cnt;
    uint32_t tag;
};

struct Prog {
    std::vector<Inst> insts;
    std::vector<uint8_t> range_lo, range_hi;
    std::vector<int32_t> multi_ncaps;
    int32_t nregexes;
    int32_t ovecsize;       // capture slots (2 * sum(ncaps_i + 1))
    uint32_t tag;
    // leading-bytes prefilter
    bool has_prefilter;
    int32_t leading_byte;   // single-byte fast case or -1
    uint8_t accept[256];    // general accepted-byte set
};

struct Capture {
    int32_t ref;
    int32_t regex_id;
    Capture* next_free;
    int64_t vector[1];      // flexible
};

struct Thread {
    int32_t pc;
    Capture* cap;
    uint8_t seen_word;
};

struct AddItem { int32_t pc; Capture* cap; };

struct Ctx {
    Prog* prog;
    uint32_t tag;
    int64_t processed_bytes;
    const uint8_t* buffer;
    Capture* matched;
    Capture* free_caps;
    int64_t last_matched_pos;
    std::vector<Thread> clist, nlist, tmp;
    std::vector<AddItem> stack;     // closure worklist (reused)
    std::vector<int32_t> initial_states;
    size_t initial_states_count;
    // exact mode: compare the FULL thread list against the start
    // closure before the prefilter re-seed.  The reference compares
    // only the first count-1 pcs, which can misidentify surviving
    // match continuations as the start state and discard them
    // (skipping the leftmost match); default false keeps the quirk
    // for byte-exact conformance, the Scanner API sets true.
    bool exact;
    int64_t* ovector;       // user buffer
    int32_t user_ovecsize;
    int64_t pending_ovector[2];
    bool first_buf, seen_start_state, eof, empty_capture;
    bool seen_newline, seen_word;
    // exact-mode cross-chunk carry: context of the byte
    // immediately before the CURRENT buffer, refreshed every
    // chunk.  The reference's seen_newline/seen_word refresh
    // only when a match fires (sre_vm_pike.c:586-601); after a
    // re-arm a chunk-start \b/^ test can consume a stale carry
    // and drop a valid match (tests/test_carry_exact.py).
    // Default mode keeps that quirk for byte-exact conformance.
    bool prev_newline, prev_word;

    Capture* cap_create() {
        Capture* c = free_caps;
        if (c) {
            free_caps = c->next_free;
        } else {
            c = (Capture*) malloc(sizeof(Capture)
                                  + (prog->ovecsize - 1)
                                  * sizeof(int64_t));
        }
        c->ref = 1;
        c->regex_id = 0;
        for (int32_t i = 0; i < prog->ovecsize; i++) c->vector[i] = -1;
        return c;
    }

    void cap_decr(Capture* c) {
        if (--c->ref == 0) {
            c->next_free = free_caps;
            free_caps = c;
        }
    }

    // COW update (sre_capture_update, sre_capture.c:59-85)
    Capture* cap_update(Capture* c, int32_t group, int64_t value) {
        if (c->ref == 1) {
            c->vector[group] = value;
            return c;
        }
        c->ref--;
        Capture* n = free_caps;
        if (n) {
            free_caps = n->next_free;
        } else {
            n = (Capture*) malloc(sizeof(Capture)
                                  + (prog->ovecsize - 1)
                                  * sizeof(int64_t));
        }
        n->ref = 1;
        n->regex_id = c->regex_id;
        memcpy(n->vector, c->vector, prog->ovecsize * sizeof(int64_t));
        n->vector[group] = value;
        return n;
    }
};

// epsilon-closure insertion (sre_vm_pike_add_thread,
// sre_vm_pike.c:756-942); returns RC_OK or RC_DONE (*pcap set)
static int add_thread(Ctx* ctx, std::vector<Thread>& lst, int32_t pc0,
                      Capture* cap0, int64_t pos, bool want_pcap,
                      Capture** pcap) {
    Prog* prog = ctx->prog;
    Inst* insts = prog->insts.data();
    const uint32_t tag = ctx->tag;
    std::vector<AddItem>& stack = ctx->stack;
    stack.clear();
    int32_t pc = pc0;
    Capture* cap = cap0;

    // reference discipline: every pending stack item, the in-register
    // (pc, cap), and every emitted thread own exactly one capture
    // reference; the caller's reference to cap0 is transferred in.
    // Single-successor chains (JMP/SAVE/SPLIT-x/entry asserts) are
    // followed in registers; only SPLIT-y branches touch the stack,
    // preserving the exact DFS (x-first) priority order.
    for (;;) {
        Inst& ins = insts[pc];
        if (ins.tag == tag) {
            // split-y retry quirk (sre_vm_pike.c:770-787)
            if (ins.opcode == OP_SPLIT
                && insts[ins.y].tag != tag) {
                if (pc == 0) ctx->seen_start_state = true;
                pc = ins.y;
                continue;
            }
            ctx->cap_decr(cap);
            goto next_item;
        }
        ins.tag = tag;
        switch (ins.opcode) {
        case OP_JMP:
            pc = ins.x;
            continue;
        case OP_SPLIT:
            if (pc == 0) ctx->seen_start_state = true;
            cap->ref++;             // two branches now share it
            stack.push_back({ins.y, cap});
            pc = ins.x;
            continue;
        case OP_SAVE:
            cap = ctx->cap_update(cap, ins.val,
                                  ctx->processed_bytes + pos);
            pc++;
            continue;
        case OP_ASSERT: {
            uint8_t seen_word = 0;
            switch (ins.val) {
            case A_BIG_A:
                if (pos || ctx->processed_bytes) {
                    ctx->cap_decr(cap);
                    goto next_item;
                }
                pc++;
                continue;
            case A_CARET:
                if ((pos == 0)
                        ? (ctx->processed_bytes
                           && !(ctx->exact ? ctx->prev_newline
                                           : ctx->seen_newline))
                        : (ctx->buffer[pos - 1] != '\n')) {
                    ctx->cap_decr(cap);
                    goto next_item;
                }
                pc++;
                continue;
            case A_SMALL_B:
            case A_BIG_B:
                seen_word = (pos == 0)
                    ? ((ctx->exact && ctx->prev_word) ? 1 : 0)
                    : (isword(ctx->buffer[pos - 1]) ? 1 : 0);
                break;
            default:
                break;  // postpone lookahead assertions ($, \z)
            }
            lst.push_back({pc, cap, seen_word});
            goto next_item;
        }
        case OP_MATCH:
            ctx->last_matched_pos = cap->vector[1];
            cap->regex_id = ins.val;
            if (want_pcap) {
                *pcap = cap;        // ownership out
                // abandoned branches die with their references
                while (!stack.empty()) {
                    ctx->cap_decr(stack.back().cap);
                    stack.pop_back();
                }
                return RC_DONE;
            }
            lst.push_back({pc, cap, 0});
            goto next_item;
        default:
            lst.push_back({pc, cap, 0});
            goto next_item;
        }
next_item:
        if (stack.empty()) return RC_OK;
        pc = stack.back().pc;
        cap = stack.back().cap;
        stack.pop_back();
    }
}

static void clear_list(Ctx* ctx, std::vector<Thread>& lst) {
    for (Thread& t : lst) ctx->cap_decr(t.cap);
    lst.clear();
}

static bool in_ranges(Prog* prog, Inst& ins, uint8_t c) {
    const uint8_t* lo = prog->range_lo.data() + ins.range_ofs;
    const uint8_t* hi = prog->range_hi.data() + ins.range_ofs;
    for (int32_t i = 0; i < ins.range_cnt; i++) {
        if (c >= lo[i] && c <= hi[i]) return true;
    }
    return false;
}

// temp captures: min start / max end of $0 over live threads, with the
// reference's literal vector[1] for ends
// (sre_vm_pike_prepare_temp_captures, sre_vm_pike.c:692-735)
static void prepare_temp_captures(Ctx* ctx) {
    Prog* prog = ctx->prog;
    ctx->ovector[0] = -1;
    ctx->ovector[1] = -1;
    for (Thread& t : ctx->clist) {
        int64_t* vec = t.cap->vector;
        int64_t ofs = 0;
        for (int32_t i = 0; i < prog->nregexes; i++) {
            int64_t b = vec[ofs];
            int64_t a = ctx->ovector[0];
            if (b != -1 && (a == -1 || b < a)) ctx->ovector[0] = b;
            b = vec[1];
            a = ctx->ovector[1];
            if (b != -1 && (a == -1 || b > a)) ctx->ovector[1] = b;
            ofs += 2 * (prog->multi_ncaps[i] + 1);
        }
    }
}

// (sre_vm_pike_prepare_matched_captures, sre_vm_pike.c:945-989)
static int prepare_matched_captures(Ctx* ctx, Capture* matched,
                                    int64_t* ovector, bool complete) {
    Prog* prog = ctx->prog;
    int32_t rid = matched->regex_id;
    if (rid >= prog->nregexes) return RC_ERROR;
    int64_t ofs = 0;
    for (int32_t i = 0; i < rid; i++) ofs += prog->multi_ncaps[i] + 1;
    ofs *= 2;
    int32_t nslots = complete ? 2 * (prog->multi_ncaps[rid] + 1) : 2;
    memcpy(ovector, matched->vector + ofs, nslots * sizeof(int64_t));
    if (complete) {
        for (int32_t j = nslots; j < ctx->user_ovecsize; j++)
            ovector[j] = -1;
    }
    return RC_OK;
}

static int64_t find_first_byte(Prog* prog, const uint8_t* input,
                               int64_t pos, int64_t last) {
    if (prog->leading_byte >= 0) {
        const void* p = memchr(input + pos,
                               prog->leading_byte, last - pos);
        return p ? (const uint8_t*) p - input : last;
    }
    for (int64_t i = pos; i < last; i++) {
        if (prog->accept[input[i]]) return i;
    }
    return last;
}

}  // namespace

extern "C" {

void* sre_pike_prog_create(
        int32_t n, const int32_t* opcode, const int32_t* x,
        const int32_t* y, const int32_t* val,
        const int32_t* range_ofs, const int32_t* range_cnt,
        const uint8_t* range_lo, const uint8_t* range_hi,
        int32_t nranges_total, int32_t nregexes,
        const int32_t* multi_ncaps, int32_t ovecsize,
        int32_t leading_byte, const uint8_t* accept256) {
    Prog* p = new Prog();
    p->insts.resize(n);
    for (int32_t i = 0; i < n; i++) {
        p->insts[i] = {opcode[i], x[i], y[i], val[i], range_ofs[i],
                       range_cnt[i], 0};
    }
    p->range_lo.assign(range_lo, range_lo + nranges_total);
    p->range_hi.assign(range_hi, range_hi + nranges_total);
    p->multi_ncaps.assign(multi_ncaps, multi_ncaps + nregexes);
    p->nregexes = nregexes;
    p->ovecsize = ovecsize;
    p->tag = 0;
    p->leading_byte = leading_byte;
    p->has_prefilter = accept256 != nullptr;
    if (accept256) memcpy(p->accept, accept256, 256);
    return p;
}

void sre_pike_prog_destroy(void* prog) {
    delete (Prog*) prog;
}

void* sre_pike_ctx_create(void* prog_, int64_t* ovector,
                          int32_t ovecsize) {
    Ctx* ctx = new Ctx();
    ctx->prog = (Prog*) prog_;
    ctx->tag = 0;
    ctx->processed_bytes = 0;
    ctx->buffer = nullptr;
    ctx->matched = nullptr;
    ctx->free_caps = nullptr;
    ctx->last_matched_pos = -1;
    ctx->initial_states_count = 0;
    ctx->exact = false;
    ctx->ovector = ovector;
    ctx->user_ovecsize = ovecsize;
    size_t n = ctx->prog->insts.size() + 8;
    ctx->clist.reserve(n);
    ctx->nlist.reserve(n);
    ctx->tmp.reserve(16);
    ctx->stack.reserve(2 * n);
    ctx->first_buf = true;
    ctx->seen_start_state = false;
    ctx->eof = false;
    ctx->empty_capture = false;
    ctx->seen_newline = false;
    ctx->seen_word = false;
    ctx->prev_newline = false;
    ctx->prev_word = false;
    return ctx;
}

// Initialize the cross-chunk carry so a stream can be entered
// mid-corpus: absolute position + the seen_newline/seen_word context
// of the byte immediately before it (sre_vm_pike.c ctx fields).
void sre_pike_ctx_set_carry(void* ctx_, int64_t processed_bytes,
                            int32_t seen_newline, int32_t seen_word) {
    Ctx* ctx = (Ctx*) ctx_;
    ctx->processed_bytes = processed_bytes;
    ctx->seen_newline = seen_newline != 0;
    ctx->seen_word = seen_word != 0;
    ctx->prev_newline = seen_newline != 0;
    ctx->prev_word = seen_word != 0;
}

void sre_pike_ctx_destroy(void* ctx_) {
    Ctx* ctx = (Ctx*) ctx_;
    clear_list(ctx, ctx->clist);
    clear_list(ctx, ctx->nlist);
    if (ctx->matched) ctx->cap_decr(ctx->matched);
    Capture* c = ctx->free_caps;
    while (c) {
        Capture* nxt = c->next_free;
        free(c);
        c = nxt;
    }
    delete ctx;
}

// One chunk (sre_vm_pike_exec, sre_vm_pike.c:148-689).
// Returns regex_id >= 0, RC_AGAIN, RC_DECLINED, or RC_ERROR.
// *pending_flag is set to 1 and pending_out[0..1] filled when a
// provisional match span exists (want_pending only).
int64_t sre_pike_exec(void* ctx_, const uint8_t* input, int64_t size,
                      int32_t eof, int32_t want_pending,
                      int64_t* pending_out, int32_t* pending_flag) {
    Ctx* ctx = (Ctx*) ctx_;
    Prog* prog = ctx->prog;
    Inst* insts = prog->insts.data();
    if (pending_flag) *pending_flag = 0;

    if (ctx->eof) return RC_ERROR;

    Capture* matched = ctx->matched;
    ctx->buffer = input;
    ctx->last_matched_pos = -1;

    int64_t spi;
    if (ctx->empty_capture) {
        ctx->empty_capture = false;
        if (size == 0) {
            if (eof) { ctx->eof = true; return RC_DECLINED; }
            return RC_AGAIN;
        }
        spi = 1;
    } else {
        spi = 0;
    }

    if (ctx->first_buf) {
        ctx->first_buf = false;
        Capture* cap = ctx->cap_create();
        ctx->tag = prog->tag + 1;
        add_thread(ctx, ctx->clist, 0, cap, spi, false, nullptr);
        ctx->initial_states_count = ctx->clist.size();
        ctx->initial_states.clear();
        {
            size_t lim = ctx->clist.size();
            if (!ctx->exact && lim > 0) lim--;  // ref quirk: skip loop
            for (size_t i = 0; i < lim; i++)
                ctx->initial_states.push_back(ctx->clist[i].pc);
        }
    } else {
        ctx->tag = prog->tag;
    }

    std::vector<Thread>& clist = ctx->clist;
    std::vector<Thread>& nlist = ctx->nlist;
    size_t chead = 0;   // consumed prefix of clist

    while (spi < size || (eof && spi == size)) {
        if (clist.size() == chead) break;

        if (prog->has_prefilter && ctx->seen_start_state) {
            ctx->seen_start_state = false;
            bool ok = (spi != size
                       && clist.size() - chead
                          == ctx->initial_states_count);
            if (ok) {
                for (size_t i = 0; i < ctx->initial_states.size();
                     i++) {
                    if (clist[chead + i].pc != ctx->initial_states[i]) {
                        ok = false;
                        break;
                    }
                }
            }
            if (ok) {
                int64_t p = find_first_byte(prog, input, spi, size);
                if (p > spi) {
                    spi = p;
                    for (size_t i = chead; i < clist.size(); i++)
                        ctx->cap_decr(clist[i].cap);
                    clist.resize(chead);
                    Capture* cap = ctx->cap_create();
                    ctx->tag++;
                    add_thread(ctx, clist, 0, cap, spi, false, nullptr);
                    if (spi == size) break;
                }
            }
        }

        ctx->tag++;
        int cur = spi < size ? input[spi] : -1;
        bool cur_is_word = spi < size && isword((uint8_t) cur);

        while (clist.size() > chead) {
            Thread t = clist[chead];
            // pop front: mark consumed (vector used as deque)
            chead++;
            Inst& ins = insts[t.pc];
            int rc;
            Capture* mcap = nullptr;

            switch (ins.opcode) {
            case OP_CHAR:
                if (cur != ins.val) { ctx->cap_decr(t.cap); continue; }
                break;
            case OP_IN:
                if (cur < 0 || !in_ranges(prog, ins, (uint8_t) cur)) {
                    ctx->cap_decr(t.cap);
                    continue;
                }
                break;
            case OP_NOTIN:
                if (cur < 0 || in_ranges(prog, ins, (uint8_t) cur)) {
                    ctx->cap_decr(t.cap);
                    continue;
                }
                break;
            case OP_ANY:
                if (cur < 0) { ctx->cap_decr(t.cap); continue; }
                break;
            case OP_ASSERT: {
                bool hold = false;
                bool seen_word;
                switch (ins.val) {
                case A_SMALL_Z:
                    hold = (spi == size);
                    break;
                case A_DOLLAR:
                    hold = (spi == size || cur == '\n');
                    break;
                case A_BIG_B:
                    // exact mode: the thread's own latch is
                    // always correct (prev_word at pos 0); the
                    // reference's stale-ctx OR stays default-only
                    seen_word = ctx->exact ? (t.seen_word != 0)
                        : (t.seen_word
                           || (spi == 0 && ctx->seen_word));
                    hold = (seen_word == cur_is_word);
                    break;
                case A_SMALL_B:
                    seen_word = ctx->exact ? (t.seen_word != 0)
                        : (t.seen_word
                           || (spi == 0 && ctx->seen_word));
                    hold = (seen_word != cur_is_word);
                    break;
                }
                if (!hold) { ctx->cap_decr(t.cap); continue; }
                // splice closure of pc+1 at the FRONT of clist
                ctx->tag--;
                ctx->tmp.clear();
                add_thread(ctx, ctx->tmp, t.pc + 1, t.cap, spi, false,
                           nullptr);
                ctx->tag++;
                if (!ctx->tmp.empty()) {
                    // prepend tmp before clist[chead]
                    clist.insert(clist.begin() + chead,
                                 ctx->tmp.begin(), ctx->tmp.end());
                }
                continue;
            }
            case OP_MATCH:
                ctx->last_matched_pos = t.cap->vector[1];
                t.cap->regex_id = ins.val;
                if (matched) ctx->cap_decr(matched);
                matched = t.cap;   // transfer the thread's reference
                for (size_t i = chead; i < clist.size(); i++)
                    ctx->cap_decr(clist[i].cap);
                clist.resize(chead);
                goto step_done;
            default:
                ctx->cap_decr(t.cap);
                continue;
            }

            // consuming op passed: advance (thread's reference
            // transfers into the closure)
            rc = add_thread(ctx, nlist, t.pc + 1, t.cap,
                            spi + 1, true, &mcap);
            if (rc == RC_DONE) {
                if (matched) ctx->cap_decr(matched);
                matched = mcap;
                for (size_t i = chead; i < clist.size(); i++)
                    ctx->cap_decr(clist[i].cap);
                clist.resize(chead);
                goto step_done;
            }
        }

step_done:
        // swap lists; clear leftovers
        clist.erase(clist.begin(), clist.begin() + chead);
        chead = 0;
        std::swap(ctx->clist, ctx->nlist);
        clear_list(ctx, ctx->nlist);
        if (spi == size) break;
        spi++;
    }
    clist.erase(clist.begin(), clist.begin() + chead);
    chead = 0;

    // exact-mode carry: the next chunk's predecessor byte is this
    // chunk's last byte (overridden below on a re-arm)
    bool entry_prev_nl = ctx->prev_newline;
    bool entry_prev_w = ctx->prev_word;
    if (size > 0) {
        ctx->prev_newline = input[size - 1] == '\n';
        ctx->prev_word = isword(input[size - 1]) != 0;
    }

    if (ctx->last_matched_pos >= 0) {
        int64_t p = ctx->last_matched_pos - ctx->processed_bytes;
        if (p > 0) {
            ctx->seen_newline = input[p - 1] == '\n';
            ctx->seen_word = isword(input[p - 1]);
        }
        ctx->last_matched_pos = -1;
    }

    prog->tag = ctx->tag;

    if (matched) {
        if (eof || ctx->clist.empty()) {
            if (prepare_matched_captures(ctx, matched, ctx->ovector,
                                         true) != RC_OK)
                return RC_ERROR;
            if (!ctx->clist.empty()) {
                clear_list(ctx, ctx->clist);
                ctx->eof = true;
            }
            // re-arm: the stream resumes at the match end; its
            // predecessor byte is the one before it in THIS
            // chunk (or unchanged at a chunk-start match end)
            {
                int64_t rel = ctx->ovector[1]
                              - ctx->processed_bytes;
                if (rel > 0) {
                    ctx->prev_newline = input[rel - 1] == '\n';
                    ctx->prev_word = isword(input[rel - 1]) != 0;
                } else {
                    ctx->prev_newline = entry_prev_nl;
                    ctx->prev_word = entry_prev_w;
                }
            }
            ctx->processed_bytes = ctx->ovector[1];
            ctx->empty_capture = ctx->ovector[0] == ctx->ovector[1];
            ctx->matched = nullptr;
            ctx->first_buf = true;
            int64_t rid = matched->regex_id;
            ctx->cap_decr(matched);
            return rid;
        }
        if (want_pending && pending_out && pending_flag) {
            *pending_flag = 1;
            if (prepare_matched_captures(ctx, matched, pending_out,
                                         false) != RC_OK)
                return RC_ERROR;
            memcpy(ctx->pending_ovector, pending_out,
                   2 * sizeof(int64_t));
        }
    } else {
        if (eof) {
            ctx->eof = true;
            ctx->matched = nullptr;
            return RC_DECLINED;
        }
    }

    ctx->processed_bytes += spi;
    ctx->matched = matched;
    prepare_temp_captures(ctx);
    return RC_AGAIN;
}

}  // extern "C"

extern "C" void sre_pike_ctx_set_exact(void* h, int32_t on) {
    static_cast<Ctx*>(h)->exact = (on != 0);
}
