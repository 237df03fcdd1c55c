// Native BPE merge core — the splintr-equivalent hot loop (SURVEY §2.9
// "splintr" row: PCRE2+JIT BPE in Rust). Pre-tokenization stays in Python
// (the `regex` package is C-backed); this library replaces the per-piece
// merge loop, the actual hot path.
//
// C ABI (ctypes):
//   void*  bpe_new(const uint8_t* blob, uint64_t len);
//   int64_t bpe_encode(void* h, const uint8_t* text, uint64_t len,
//                      uint32_t* out, uint64_t out_cap);
//   void   bpe_free(void* h);
//
// Vocab blob: [u32 n] then n × ([u16 len][bytes][u32 id]), little-endian.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Bpe {
    std::unordered_map<std::string, uint32_t> ranks;
};

// Encode one pre-tokenized piece: greedy lowest-rank pair merging
// (tiktoken semantics).
void encode_piece(const Bpe& bpe, const uint8_t* data, size_t len,
                  std::vector<uint32_t>& out) {
    if (len == 0) return;
    {   // whole-piece fast path
        std::string whole(reinterpret_cast<const char*>(data), len);
        auto it = bpe.ranks.find(whole);
        if (it != bpe.ranks.end()) {
            out.push_back(it->second);
            return;
        }
    }
    // parts[i] = (start, end) byte ranges
    std::vector<std::pair<size_t, size_t>> parts;
    parts.reserve(len);
    for (size_t i = 0; i < len; ++i) parts.emplace_back(i, i + 1);

    std::string key;
    while (parts.size() > 1) {
        uint32_t best_rank = UINT32_MAX;
        size_t best_idx = SIZE_MAX;
        for (size_t i = 0; i + 1 < parts.size(); ++i) {
            key.assign(reinterpret_cast<const char*>(data) + parts[i].first,
                       parts[i + 1].second - parts[i].first);
            auto it = bpe.ranks.find(key);
            if (it != bpe.ranks.end() && it->second < best_rank) {
                best_rank = it->second;
                best_idx = i;
            }
        }
        if (best_idx == SIZE_MAX) break;
        parts[best_idx].second = parts[best_idx + 1].second;
        parts.erase(parts.begin() + best_idx + 1);
    }
    for (auto& p : parts) {
        key.assign(reinterpret_cast<const char*>(data) + p.first,
                   p.second - p.first);
        auto it = bpe.ranks.find(key);
        if (it != bpe.ranks.end()) {
            out.push_back(it->second);
        } else {
            // byte fallback
            for (size_t b = p.first; b < p.second; ++b) {
                std::string one(reinterpret_cast<const char*>(data) + b, 1);
                auto bit = bpe.ranks.find(one);
                if (bit != bpe.ranks.end()) out.push_back(bit->second);
            }
        }
    }
}

}  // namespace

extern "C" {

void* bpe_new(const uint8_t* blob, uint64_t len) {
    if (len < 4) return nullptr;
    auto* bpe = new Bpe();
    uint32_t n;
    std::memcpy(&n, blob, 4);
    uint64_t pos = 4;
    bpe->ranks.reserve(n * 2);
    for (uint32_t i = 0; i < n; ++i) {
        if (pos + 2 > len) { delete bpe; return nullptr; }
        uint16_t tlen;
        std::memcpy(&tlen, blob + pos, 2);
        pos += 2;
        if (pos + tlen + 4 > len) { delete bpe; return nullptr; }
        std::string tok(reinterpret_cast<const char*>(blob + pos), tlen);
        pos += tlen;
        uint32_t id;
        std::memcpy(&id, blob + pos, 4);
        pos += 4;
        bpe->ranks.emplace(std::move(tok), id);
    }
    return bpe;
}

// Encode a single piece (caller pre-tokenizes). Returns token count or -1
// if out_cap is too small.
int64_t bpe_encode(void* h, const uint8_t* text, uint64_t len,
                   uint32_t* out_ids, uint64_t out_cap) {
    auto* bpe = static_cast<Bpe*>(h);
    std::vector<uint32_t> out;
    encode_piece(*bpe, text, len, out);
    if (out.size() > out_cap) return -1;
    std::memcpy(out_ids, out.data(), out.size() * sizeof(uint32_t));
    return static_cast<int64_t>(out.size());
}

// Encode many pieces at once: offsets[i]..offsets[i+1] delimit piece i in
// `text`. Amortizes the ctypes boundary over a whole document.
int64_t bpe_encode_batch(void* h, const uint8_t* text,
                         const uint64_t* offsets, uint64_t n_pieces,
                         uint32_t* out_ids, uint64_t out_cap) {
    auto* bpe = static_cast<Bpe*>(h);
    std::vector<uint32_t> out;
    out.reserve(n_pieces * 2);
    for (uint64_t i = 0; i < n_pieces; ++i) {
        encode_piece(*bpe, text + offsets[i], offsets[i + 1] - offsets[i], out);
    }
    if (out.size() > out_cap) return -1;
    std::memcpy(out_ids, out.data(), out.size() * sizeof(uint32_t));
    return static_cast<int64_t>(out.size());
}

void bpe_free(void* h) { delete static_cast<Bpe*>(h); }

// ---------------------------------------------------------------------------
// Native pre-tokenizer: the cl100k-family pattern evaluated as a scanner.
//
//   '(?:[sdmt]|ll|ve|re) | ?\p{L}+ | ?\p{N}+ | ?[^\s\p{L}\p{N}]+
//   | \s+(?!\S) | \s+
//
// Unicode categories come from a per-codepoint table built by Python with
// the SAME regex engine used by the fallback path, so the two paths agree
// exactly. Categories: 0 other, 1 letter, 2 number, 3 whitespace.
// ---------------------------------------------------------------------------

namespace {

constexpr uint8_t C_OTHER = 0, C_LETTER = 1, C_NUMBER = 2, C_SPACE = 3;

struct Cats {
    std::vector<uint8_t> t;
    uint8_t of(uint32_t cp) const { return cp < t.size() ? t[cp] : C_OTHER; }
};

// Decode one UTF-8 codepoint; invalid sequences yield (0xFFFD, 1).
inline uint32_t utf8_decode(const uint8_t* p, uint64_t left, uint32_t* n) {
    uint8_t b = p[0];
    if (b < 0x80) { *n = 1; return b; }
    uint32_t len = (b >= 0xF0) ? 4 : (b >= 0xE0) ? 3 : (b >= 0xC0) ? 2 : 1;
    if (len == 1 || len > left) { *n = 1; return 0xFFFD; }
    static const uint8_t mask[5] = {0, 0x7F, 0x1F, 0x0F, 0x07};
    uint32_t cp = b & mask[len];
    for (uint32_t i = 1; i < len; ++i) {
        if ((p[i] & 0xC0) != 0x80) { *n = 1; return 0xFFFD; }
        cp = (cp << 6) | (p[i] & 0x3F);
    }
    *n = len;
    return cp;
}

constexpr int MODE_GPT2 = 0;
constexpr int MODE_CL100K = 1;

inline bool is_crlf(uint32_t cp) { return cp == '\r' || cp == '\n'; }

// Case-insensitive contraction: '(?i:[sdmt]|ll|ve|re). `ci` false = the
// GPT-2 pattern's case-sensitive version.
inline uint64_t match_contraction(const uint8_t* s, uint64_t len,
                                  uint64_t pos, bool ci) {
    if (s[pos] != '\'' || pos + 1 >= len) return pos;
    uint8_t a = s[pos + 1];
    if (ci) a |= 0x20;
    if (a == 's' || a == 'd' || a == 'm' || a == 't') return pos + 2;
    if (pos + 2 < len) {
        uint8_t b = s[pos + 2];
        if (ci) b |= 0x20;
        if ((a == 'l' && b == 'l') || (a == 'v' && b == 'e') ||
            (a == 'r' && b == 'e'))
            return pos + 3;
    }
    return pos;
}

// Scan one piece starting at `pos`; returns the end byte offset.
// mode selects which public pattern's semantics are evaluated.
uint64_t next_piece(const Cats& cats, const uint8_t* s, uint64_t len,
                    uint64_t pos, int mode) {
    uint32_t n0;
    uint32_t cp0 = utf8_decode(s + pos, len - pos, &n0);
    uint8_t c0 = cats.of(cp0);

    // run of a single category starting at byte q
    auto run = [&](uint64_t q, uint8_t want) {
        while (q < len) {
            uint32_t n;
            uint32_t cp = utf8_decode(s + q, len - q, &n);
            if (cats.of(cp) != want) break;
            q += n;
        }
        return q;
    };
    // last codepoint start within [from, to)
    auto last_cp_start = [&](uint64_t from, uint64_t to) {
        uint64_t last = from, it = from;
        while (it < to) {
            uint32_t n;
            utf8_decode(s + it, to - it, &n);
            last = it;
            it += n;
        }
        return last;
    };

    if (mode == MODE_CL100K) {
        // '(?i:[sdmt]|ll|ve|re) | [^\r\n\p{L}\p{N}]?+\p{L}+ | \p{N}{1,3}
        // |  ?[^\s\p{L}\p{N}]++[\r\n]* | \s*[\r\n] | \s+(?!\S) | \s+
        uint64_t e = match_contraction(s, len, pos, true);
        if (e > pos) return e;
        // alt2: possessive optional [^\r\n L N] then letters
        if (c0 == C_LETTER) return run(pos, C_LETTER);
        if (c0 != C_NUMBER && !is_crlf(cp0) && pos + n0 < len) {
            uint32_t n1;
            uint32_t cp1 = utf8_decode(s + pos + n0, len - pos - n0, &n1);
            if (cats.of(cp1) == C_LETTER) return run(pos + n0, C_LETTER);
        }
        // alt3: 1-3 digits
        if (c0 == C_NUMBER) {
            uint64_t q = pos;
            for (int k = 0; k < 3 && q < len; ++k) {
                uint32_t n;
                uint32_t cp = utf8_decode(s + q, len - q, &n);
                if (cats.of(cp) != C_NUMBER) break;
                q += n;
            }
            return q;
        }
        // alt4:  ?[^\s L N]++ [\r\n]*
        {
            uint64_t q = pos;
            if (cp0 == ' ') q = pos + 1;
            if (q < len) {
                uint64_t e4 = run(q, C_OTHER);
                if (e4 > q) {
                    while (e4 < len && is_crlf(s[e4])) ++e4;
                    return e4;
                }
            }
        }
        if (c0 == C_SPACE) {
            uint64_t q = run(pos, C_SPACE);
            // alt5: \s*[\r\n] — up to and including the run's last newline
            uint64_t last_nl = 0;
            bool has_nl = false;
            for (uint64_t it = pos; it < q; ++it)
                if (is_crlf(s[it])) { last_nl = it; has_nl = true; }
            if (has_nl) return last_nl + 1;
            // alt6: \s+(?!\S)
            if (q >= len) return q;
            uint64_t last = last_cp_start(pos, q);
            return (last == pos) ? q : last;   // single-cp run: alt7
        }
        return pos + n0;                       // unreachable safety
    }

    // MODE_GPT2:
    // '(?:[sdmt]|ll|ve|re) | ?\p{L}+ | ?\p{N}+ | ?[^\s\p{L}\p{N}]+
    // | \s+(?!\S) | \s+
    uint64_t e = match_contraction(s, len, pos, false);
    if (e > pos) return e;

    if (cp0 == ' ' && pos + 1 < len) {
        uint32_t n1;
        uint32_t cp1 = utf8_decode(s + pos + 1, len - pos - 1, &n1);
        uint8_t c1 = cats.of(cp1);
        if (c1 == C_LETTER) return run(pos + 1, C_LETTER);
        if (c1 == C_NUMBER) return run(pos + 1, C_NUMBER);
        if (c1 == C_OTHER) return run(pos + 1, C_OTHER);
        // next is whitespace → fall through to the \s alternatives
    }
    if (c0 == C_LETTER) return run(pos, C_LETTER);
    if (c0 == C_NUMBER) return run(pos, C_NUMBER);
    if (c0 == C_OTHER) return run(pos, C_OTHER);

    // c0 == C_SPACE: alt 5 `\s+(?!\S)` then alt 6 `\s+`.
    uint64_t q = run(pos, C_SPACE);
    if (q >= len) return q;                 // trailing whitespace: all of it
    uint64_t last = last_cp_start(pos, q);
    return (last == pos) ? q : last;
}

}  // namespace

void* bpe_cats_new(const uint8_t* table, uint64_t n) {
    auto* c = new Cats();
    c->t.assign(table, table + n);
    return c;
}

void bpe_cats_free(void* c) { delete static_cast<Cats*>(c); }

// Pre-tokenize + merge in one call. mode: 0 = GPT-2 pattern, 1 = cl100k.
// Returns token count, or -1 if out_cap is too small.
int64_t bpe_encode_text(void* h, void* catsv, const uint8_t* text,
                        uint64_t len, int32_t mode, uint32_t* out_ids,
                        uint64_t out_cap) {
    auto* bpe = static_cast<Bpe*>(h);
    auto* cats = static_cast<Cats*>(catsv);
    std::vector<uint32_t> out;
    out.reserve(len / 3 + 8);
    uint64_t pos = 0;
    while (pos < len) {
        uint64_t end = next_piece(*cats, text, len, pos, mode);
        if (end <= pos) end = pos + 1;      // safety: always advance
        encode_piece(*bpe, text + pos, end - pos, out);
        pos = end;
    }
    if (out.size() > out_cap) return -1;
    std::memcpy(out_ids, out.data(), out.size() * sizeof(uint32_t));
    return static_cast<int64_t>(out.size());
}

}  // extern "C"
