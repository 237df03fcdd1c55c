// Exact pushdown-automaton grammar engine (GBNF constrained decoding).
//
// The port's copy of blazr_tpu/native/pda.cpp, built by
// blazr_tpu_torch/native/__init__.py with g++ on first use.
//
// Third tier of the grammar stack (blazr_tpu_torch/engine/grammar.py): the DFA
// tiers are exact for shallow grammars and over-approximate for deeply
// recursive ones (bounded-depth expansion); this PDA tracks the real
// rule stack, so arbitrarily nested JSON/expression grammars get exact
// token masks. Reference analogue: the byte-level grammar sampler in
// src/engine/grammar.rs (which is DFA-only — this tier is an improvement).
//
// Model: a configuration is a stack of element indices (continuations).
// The machine state is a SET of stacks (the grammar may be ambiguous).
// Elements live in one flat array; each alternate's elements are
// contiguous and terminated by END. Matching a CHAR advances the top;
// reaching a REF pushes the continuation + each alternate of the callee;
// an empty stack accepts.
//
// Exposed C ABI (ctypes): see blazr_tpu_torch/engine/grammar_pda.py.

#include <array>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <unordered_set>
#include <algorithm>

namespace {

constexpr uint8_t EL_END = 0;
constexpr uint8_t EL_CHAR = 1;
constexpr uint8_t EL_REF = 2;

constexpr size_t MAX_STACKS = 1024;    // configuration-set cap
constexpr size_t MAX_DEPTH = 4096;     // single-stack depth cap

struct Element {
    uint8_t kind;
    uint32_t arg;      // CHAR: class id, REF: rule id
};

struct Grammar {
    std::vector<std::array<uint64_t, 4>> classes;  // 256-bit byte bitmaps
    std::vector<Element> elems;                    // flat element array
    std::vector<std::vector<uint32_t>> rule_alts;  // rule -> alt start idx

    bool class_match(uint32_t cls, uint8_t b) const {
        return (classes[cls][b >> 6] >> (b & 63)) & 1;
    }
};

using Stack = std::vector<uint32_t>;   // element indices; back() = top

struct StackSetHash {
    size_t operator()(const Stack& s) const {
        size_t h = 1469598103934665603ull;
        for (uint32_t v : s) { h ^= v; h *= 1099511628211ull; }
        return h;
    }
};

struct State {
    std::vector<Stack> stacks;
    bool overflowed = false;
};

// Expand a stack until its top is a CHAR element (or it is empty).
// Appends results to `out` (deduped by caller). Returns false on overflow.
bool expand(const Grammar& g, Stack st,
            std::vector<Stack>& out,
            std::unordered_set<Stack, StackSetHash>& seen) {
    // Iterative worklist: each entry is a stack to normalize.
    std::vector<Stack> work;
    work.push_back(std::move(st));
    while (!work.empty()) {
        Stack cur = std::move(work.back());
        work.pop_back();
        if (cur.size() > MAX_DEPTH) return false;
        if (cur.empty()) {
            if (seen.insert(cur).second) out.push_back(cur);
            continue;
        }
        const Element& e = g.elems[cur.back()];
        if (e.kind == EL_CHAR) {
            if (seen.insert(cur).second) out.push_back(std::move(cur));
        } else if (e.kind == EL_END) {
            cur.pop_back();                      // return to caller
            work.push_back(std::move(cur));
        } else {                                 // EL_REF
            uint32_t ret = cur.back() + 1;       // continuation
            cur.pop_back();
            const Element& nxt = g.elems[ret];
            for (uint32_t alt_start : g.rule_alts[e.arg]) {
                Stack branch = cur;
                if (nxt.kind != EL_END) branch.push_back(ret);
                branch.push_back(alt_start);
                if (out.size() + work.size() > MAX_STACKS) return false;
                work.push_back(std::move(branch));
            }
        }
        if (out.size() > MAX_STACKS) return false;
    }
    return true;
}

// Advance a state by one byte. Returns false on overflow; result may be
// empty (= dead).
bool advance(const Grammar& g, const State& in, uint8_t b, State& out) {
    out.stacks.clear();
    std::unordered_set<Stack, StackSetHash> seen;
    for (const Stack& st : in.stacks) {
        if (st.empty()) continue;                // accepted; no more input
        const Element& e = g.elems[st.back()];
        // invariant: tops are CHAR
        if (e.kind != EL_CHAR || !g.class_match(e.arg, b)) continue;
        Stack nxt = st;
        nxt.back() += 1;                         // past the matched char
        if (!expand(g, std::move(nxt), out.stacks, seen)) return false;
    }
    return true;
}

struct Trie {
    struct Node {
        int32_t token = -1;
        std::vector<std::pair<uint8_t, uint32_t>> kids;  // sorted by byte
    };
    std::vector<Node> nodes;
    uint32_t vocab = 0;

    uint32_t child(uint32_t n, uint8_t b) {
        auto& kids = nodes[n].kids;
        auto it = std::lower_bound(kids.begin(), kids.end(), b,
            [](const std::pair<uint8_t, uint32_t>& p, uint8_t v) {
                return p.first < v; });
        if (it != kids.end() && it->first == b) return it->second;
        kids.insert(it, {b, (uint32_t)nodes.size()});
        nodes.emplace_back();
        // note: `it` invalidated; return the index we just wrote
        return (uint32_t)(nodes.size() - 1);
    }
};

void mask_dfs(const Grammar& g, const Trie& trie, uint32_t node,
              const State& st, uint8_t* out) {
    const Trie::Node& n = trie.nodes[node];
    if (n.token >= 0) out[n.token] = 1;
    for (const auto& [b, kid] : n.kids) {
        State nxt;
        if (!advance(g, st, b, nxt)) continue;   // overflow: treat as dead
        if (nxt.stacks.empty()) continue;
        mask_dfs(g, trie, kid, nxt, out);
    }
}

uint32_t read_u32(const uint8_t*& p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
}

}  // namespace

extern "C" {

// Blob: u32 n_classes; n_classes*32B bitmaps; u32 n_rules;
// per rule: u32 n_alts; per alt: u32 n_elems; per elem: u8 kind, u32 arg.
void* pda_new(const uint8_t* blob, uint64_t len) {
    auto* g = new Grammar();
    const uint8_t* p = blob;
    const uint8_t* end = blob + len;
    uint32_t n_classes = read_u32(p);
    g->classes.resize(n_classes);
    for (uint32_t i = 0; i < n_classes; i++) {
        std::memcpy(g->classes[i].data(), p, 32);
        p += 32;
    }
    uint32_t n_rules = read_u32(p);
    g->rule_alts.resize(n_rules);
    for (uint32_t r = 0; r < n_rules; r++) {
        uint32_t n_alts = read_u32(p);
        for (uint32_t a = 0; a < n_alts; a++) {
            uint32_t n_el = read_u32(p);
            g->rule_alts[r].push_back((uint32_t)g->elems.size());
            for (uint32_t e = 0; e < n_el; e++) {
                uint8_t kind = *p++;
                uint32_t arg = read_u32(p);
                g->elems.push_back({kind, arg});
            }
            g->elems.push_back({EL_END, 0});
        }
    }
    if (p > end) { delete g; return nullptr; }
    return g;
}

void pda_free(void* g) { delete static_cast<Grammar*>(g); }

void* pda_vocab_new(const uint8_t* bytes, const uint32_t* offsets,
                    uint32_t vocab) {
    auto* t = new Trie();
    t->vocab = vocab;
    t->nodes.emplace_back();                     // root
    for (uint32_t i = 0; i < vocab; i++) {
        uint32_t lo = offsets[i], hi = offsets[i + 1];
        if (lo == hi) continue;                  // empty token: never legal
        uint32_t n = 0;
        for (uint32_t j = lo; j < hi; j++) n = t->child(n, bytes[j]);
        t->nodes[n].token = (int32_t)i;
    }
    return t;
}

void pda_vocab_free(void* t) { delete static_cast<Trie*>(t); }

// Initial state for grammar g (root = rule 0). Returns null on overflow.
void* pda_state_new(void* gv) {
    auto* g = static_cast<Grammar*>(gv);
    auto* st = new State();
    std::unordered_set<Stack, StackSetHash> seen;
    for (uint32_t alt_start : g->rule_alts[0]) {
        Stack s;
        s.push_back(alt_start);
        if (!expand(*g, std::move(s), st->stacks, seen)) {
            delete st;
            return nullptr;
        }
    }
    return st;
}

void pda_state_free(void* st) { delete static_cast<State*>(st); }

void* pda_state_clone(void* st) {
    return new State(*static_cast<State*>(st));
}

// Advance by token bytes. Returns 1 on success (state mutated), 0 if the
// token is illegal (state unchanged), -1 on overflow (caller should fall
// back to the DFA tier).
int pda_state_accept(void* gv, void* stv, const uint8_t* data, uint32_t n) {
    auto* g = static_cast<Grammar*>(gv);
    auto* st = static_cast<State*>(stv);
    State cur = *st, nxt;
    for (uint32_t i = 0; i < n; i++) {
        if (!advance(*g, cur, data[i], nxt)) return -1;
        if (nxt.stacks.empty()) return 0;
        std::swap(cur, nxt);
    }
    *st = std::move(cur);
    return 1;
}

// 1 iff the state accepts (some configuration consumed a full root
// derivation) — EOS legality.
int pda_state_accepting(void* stv) {
    auto* st = static_cast<State*>(stv);
    for (const Stack& s : st->stacks)
        if (s.empty()) return 1;
    return 0;
}

// Fill out[vocab] with 1 for tokens legal from this state.
void pda_mask(void* gv, void* tv, void* stv, uint8_t* out) {
    auto* g = static_cast<Grammar*>(gv);
    auto* t = static_cast<Trie*>(tv);
    auto* st = static_cast<State*>(stv);
    std::memset(out, 0, t->vocab);
    // prune: a trie node's token is marked when REACHED, i.e. after its
    // final byte kept >=1 live stack — so mark-then-descend from root.
    for (const auto& [b, kid] : t->nodes[0].kids) {
        State nxt;
        if (!advance(*g, *st, b, nxt)) continue;
        if (nxt.stacks.empty()) continue;
        mask_dfs(*g, *t, kid, nxt, out);
    }
}

}  // extern "C"
