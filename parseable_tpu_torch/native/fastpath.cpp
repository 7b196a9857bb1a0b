// Native plain-JSON ingest lane of parseable_tpu_torch.
//
// Counterpart of parseable_tpu/native/fastpath.cpp, trimmed to what the
// plain-JSON ingest ladder runs:
//
//  - ptpu_flatten_ndjson: parse + flatten a JSON payload straight to NDJSON
//    (the NDJSON tier; pyarrow's JSON reader builds the columns);
//  - ptpu_flatten_columnar / ptpu_flatten_columnar_sharded: parse + flatten
//    straight into Arrow-layout column buffers in one pass (the columnar
//    tier), optionally split at record boundaries over a native worker
//    pool and stitched back in payload order;
//  - ptpu_cols_*: the columnar result ABI (zero-copy import on the Python
//    side, one ptpu_cols_free per result);
//  - ptpu_parse_pool_shutdown / ptpu_parse_pool_size: the pool's lifecycle.
//
// Every entry point returns PTPU_FJ_OK, PTPU_FJ_FALLBACK (the payload needs
// a lower tier) or PTPU_FJ_INVALID (malformed JSON: the Python lane's
// json.loads reports it). Exposed as a C ABI consumed via ctypes
// (parseable_tpu_torch/native/__init__.py builds it with g++ at first use).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cfloat>

// ------------------------------------------------------- JSON flatten (ingest)
//
// ptpu_flatten_ndjson: parse an ingest payload (JSON object or array of
// objects) and emit the FLATTENED records as NDJSON, one line per record,
// nested-object keys joined with `sep` — the wire format pyarrow's C++
// JSON reader consumes directly, so the ingest hot loop never materializes
// Python dicts on this path.
//
// CONSERVATIVE by design: any shape whose flatten semantics involve more
// than dotted-key collapsing returns PTPU_FJ_FALLBACK and the caller runs
// the exact Python path. That covers: any array value (cross-product /
// columnar-array semantics), depth over the configured limit, records
// whose key sets differ (the Python fast path declines those too),
// duplicate flattened keys (dict last-wins is position-dependent),
// non-object records, nonstandard tokens (NaN/Infinity — Python's json
// accepts them), and empty records.

extern "C" {

enum { PTPU_FJ_OK = 0, PTPU_FJ_FALLBACK = 1, PTPU_FJ_INVALID = 2 };

}  // extern "C"

#include <string>
#include <vector>
#include <algorithm>
#include <cstdlib>

namespace {

struct FlattenCtx {
    const char* p;
    const char* end;
    int max_depth;
    const char* sep;
    size_t seplen;
    std::string out;              // NDJSON result (rows written in place —
                                  // any failure discards the whole payload)
    bool row_has_fields = false;
    // Key-set uniformity via EXACT in-order comparison against record 0:
    // real producers serialize records with one key order, so each later
    // record just compares its flattened keys positionally — no per-key
    // hashing or sorting, and no collision surface at all. Same keys in a
    // DIFFERENT order (or any mismatch) takes the safe Python fallback.
    std::vector<std::string> first_keys;  // record 0, insertion order
    size_t key_pos = 0;                   // position within first_keys
    uint64_t nrows = 0;
    int rc = PTPU_FJ_OK;

    bool fail(int code) { rc = code; return false; }

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
    }

    // span of a JSON string INCLUDING quotes; escapes preserved verbatim.
    // memchr-based: most payload bytes live inside strings and the
    // vectorized closing-quote search beats the byte loop ~5x
    bool string_span(const char*& s0, const char*& s1) {
        if (p >= end || *p != '"') return fail(PTPU_FJ_INVALID);
        s0 = p++;
        while (true) {
            const char* q = (const char*)std::memchr(p, '"', (size_t)(end - p));
            if (q == nullptr) return fail(PTPU_FJ_INVALID);
            // a quote preceded by an odd number of backslashes is escaped
            const char* r = q;
            while (r > p && r[-1] == '\\') r--;
            if (((size_t)(q - r) & 1) == 0) {
                s1 = p = q + 1;
                return true;
            }
            p = q + 1;
        }
    }

    // span of a scalar value (string/number/true/false/null), verbatim
    bool scalar_span(const char*& v0, const char*& v1) {
        if (p >= end) return fail(PTPU_FJ_INVALID);
        char c = *p;
        if (c == '"') return string_span(v0, v1);
        if (c == 't' || c == 'f' || c == 'n') {
            const char* kw = c == 't' ? "true" : (c == 'f' ? "false" : "null");
            size_t n = std::strlen(kw);
            if ((size_t)(end - p) < n || std::strncmp(p, kw, n) != 0)
                return fail(PTPU_FJ_FALLBACK);  // NaN, etc.: Python decides
            v0 = p; p += n; v1 = p;
            return true;
        }
        if (c == '-' || (c >= '0' && c <= '9')) {
            // strict JSON number grammar: the token is re-emitted verbatim,
            // so lax scanning (e.g. leading-zero "00") would ingest
            // malformed JSON instead of erroring via Python's json.loads
            v0 = p;
            if (*p == '-') p++;
            if (p < end && (*p == 'I' || *p == 'N'))
                return fail(PTPU_FJ_FALLBACK);  // -Infinity / NaN
            if (p >= end || *p < '0' || *p > '9') return fail(PTPU_FJ_INVALID);
            if (*p == '0') p++;
            else while (p < end && *p >= '0' && *p <= '9') p++;
            if (p < end && *p == '.') {
                p++;
                const char* d0 = p;
                while (p < end && *p >= '0' && *p <= '9') p++;
                if (p == d0) return fail(PTPU_FJ_INVALID);
            }
            if (p < end && (*p == 'e' || *p == 'E')) {
                p++;
                if (p < end && (*p == '+' || *p == '-')) p++;
                const char* d0 = p;
                while (p < end && *p >= '0' && *p <= '9') p++;
                if (p == d0) return fail(PTPU_FJ_INVALID);
            }
            v1 = p;
            return true;
        }
        if (c == 'N' || c == 'I') return fail(PTPU_FJ_FALLBACK);
        return fail(PTPU_FJ_INVALID);
    }

    // flatten one object's members into `row`; prefix is the raw (escaped)
    // joined key text, without quotes
    bool flatten_obj(std::string& prefix, int depth) {
        if (depth > max_depth) return fail(PTPU_FJ_FALLBACK);
        if (p >= end || *p != '{') return fail(PTPU_FJ_INVALID);
        p++;
        skip_ws();
        if (p < end && *p == '}') { p++; return true; }
        while (true) {
            skip_ws();
            const char* k0; const char* k1;
            if (!string_span(k0, k1)) return false;
            skip_ws();
            if (p >= end || *p != ':') return fail(PTPU_FJ_INVALID);
            p++;
            skip_ws();
            size_t plen = prefix.size();
            if (plen) prefix.append(sep, seplen);
            prefix.append(k0 + 1, (size_t)(k1 - k0) - 2);
            if (p < end && *p == '{') {
                if (!flatten_obj(prefix, depth + 1)) return false;
            } else if (p < end && *p == '[') {
                return fail(PTPU_FJ_FALLBACK);  // array semantics: Python
            } else {
                const char* v0; const char* v1;
                if (!scalar_span(v0, v1)) return false;
                if (row_has_fields) out += ',';
                row_has_fields = true;
                out += '"';
                out.append(prefix);
                out += '"';
                out += ':';
                out.append(v0, (size_t)(v1 - v0));
                if (nrows == 0) {
                    first_keys.push_back(prefix);
                } else if (key_pos >= first_keys.size() ||
                           first_keys[key_pos] != prefix) {
                    return fail(PTPU_FJ_FALLBACK);  // sparse/reordered keys
                }
                key_pos++;
            }
            prefix.resize(plen);
            skip_ws();
            if (p < end && *p == ',') { p++; continue; }
            if (p < end && *p == '}') { p++; return true; }
            return fail(PTPU_FJ_INVALID);
        }
    }

    bool record() {
        skip_ws();
        if (p >= end || *p != '{')
            return fail(PTPU_FJ_FALLBACK);  // non-object element
        out += '{';
        row_has_fields = false;
        key_pos = 0;
        std::string prefix;
        if (!flatten_obj(prefix, 1)) return false;
        if (key_pos == 0) return fail(PTPU_FJ_FALLBACK);  // empty record
        if (nrows == 0) {
            // exact duplicate check once, on the reference record
            std::vector<std::string> sorted(first_keys);
            std::sort(sorted.begin(), sorted.end());
            for (size_t i = 1; i < sorted.size(); i++)
                if (sorted[i] == sorted[i - 1])
                    return fail(PTPU_FJ_FALLBACK);  // duplicate flattened key
        } else if (key_pos != first_keys.size()) {
            return fail(PTPU_FJ_FALLBACK);  // sparse keys: Python declines too
        }
        out += '}';
        out += '\n';
        nrows++;
        return true;
    }

    bool run() {
        skip_ws();
        if (p >= end) return fail(PTPU_FJ_INVALID);
        if (*p == '[') {
            p++;
            skip_ws();
            if (p < end && *p == ']') { p++; }
            else {
                while (true) {
                    if (!record()) return false;
                    skip_ws();
                    if (p < end && *p == ',') { p++; continue; }
                    if (p < end && *p == ']') { p++; break; }
                    return fail(PTPU_FJ_INVALID);
                }
            }
        } else if (*p == '{') {
            if (!record()) return false;
        } else {
            return fail(PTPU_FJ_FALLBACK);
        }
        skip_ws();
        if (p != end) return fail(PTPU_FJ_INVALID);
        return true;
    }
};

}  // namespace

extern "C" {

// Returns PTPU_FJ_OK and malloc'd NDJSON in *out (free with ptpu_free),
// PTPU_FJ_FALLBACK when the payload needs the exact Python path, or
// PTPU_FJ_INVALID for malformed JSON (caller surfaces the parse error
// through the Python path's own json.loads for a consistent message).
int ptpu_flatten_ndjson(const char* in, uint64_t len, int max_depth,
                        const char* sep, char** out, uint64_t* out_len,
                        uint64_t* nrows) {
    FlattenCtx ctx;
    ctx.p = in;
    ctx.end = in + len;
    ctx.max_depth = max_depth;
    ctx.sep = sep;
    ctx.seplen = std::strlen(sep);
    ctx.out.reserve((size_t)(len + len / 4));
    if (!ctx.run()) return ctx.rc;
    // malloc(0) may return nullptr, and memcpy with a null pointer is UB
    // even for zero bytes — allocate at least one byte and copy only when
    // there is output.
    char* buf = (char*)std::malloc(ctx.out.empty() ? 1 : ctx.out.size());
    if (!buf) return PTPU_FJ_FALLBACK;
    if (!ctx.out.empty()) std::memcpy(buf, ctx.out.data(), ctx.out.size());
    *out = buf;
    *out_len = ctx.out.size();
    *nrows = ctx.nrows;
    return PTPU_FJ_OK;
}

void ptpu_free(void* ptr) { std::free(ptr); }

}  // extern "C"

// ------------------------------------------------------- token scanner
//
// The cursor the columnar lane walks the payload with: whitespace, string
// spans (escapes preserved) and scalar spans under the strict JSON grammar.

#include <string_view>

// anonymous namespace: internal linkage so the compiler can inline across
// these helpers inside the -fPIC shared object (a named namespace leaves
// them interposable, which blocked inlining and cost ~6x on the hot walk)
namespace {
namespace jscan {

enum { OK = PTPU_FJ_OK, FB = PTPU_FJ_FALLBACK, INV = PTPU_FJ_INVALID };

struct Span {
    const char* b = nullptr;
    const char* e = nullptr;
    bool present() const { return b != nullptr; }
    size_t len() const { return (size_t)(e - b); }
};

// token kinds by first byte of a value span
enum Kind { K_STR, K_NUM, K_OBJ, K_ARR, K_TRUE, K_FALSE, K_NULL, K_BAD };

static Kind kind_of(const Span& v) {
    if (!v.present() || v.len() == 0) return K_BAD;
    switch (*v.b) {
        case '"': return K_STR;
        case '{': return K_OBJ;
        case '[': return K_ARR;
        case 't': return K_TRUE;
        case 'f': return K_FALSE;
        case 'n': return K_NULL;
        default: return K_NUM;
    }
}

// string span content (inside the quotes, escapes preserved)
static Span str_content(const Span& s) { return {s.b + 1, s.e - 1}; }

struct Cur {
    const char* p;
    const char* end;
    int rc = OK;

    bool fail(int c) { rc = c; return false; }

    inline void ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
    }

    // memchr-based string scan: most payload bytes live inside strings,
    // and the vectorized closing-quote search is ~5x the byte loop
    inline bool str_span(Span& s) {
        if (p >= end || *p != '"') return fail(INV);
        s.b = p++;
        while (true) {
            const char* q = (const char*)std::memchr(p, '"', (size_t)(end - p));
            if (q == nullptr) return fail(INV);
            // a quote preceded by an odd number of backslashes is escaped
            const char* r = q;
            while (r > p && r[-1] == '\\') r--;
            if (((size_t)(q - r) & 1) == 0) {
                s.e = p = q + 1;
                return true;
            }
            p = q + 1;
        }
    }

    // span of a scalar value (string/number/true/false/null) at the
    // cursor; the caller has ruled out objects and arrays
    bool scalar_span(Span& v) {
        ws();
        v.b = p;
        if (p >= end) return fail(INV);
        char c = *p;
        if (c == '"') return str_span(v);
        if (c == 't' || c == 'f' || c == 'n') {
            const char* kw = c == 't' ? "true" : (c == 'f' ? "false" : "null");
            size_t n = std::strlen(kw);
            if ((size_t)(end - p) < n || std::strncmp(p, kw, n) != 0) return fail(FB);
            p += n;
            v.e = p;
            return true;
        }
        if (c == '-' || (c >= '0' && c <= '9')) {
            // strict JSON number grammar: a lax scan would let malformed
            // input (e.g. leading-zero "00") ingest instead of erroring
            // through the Python json.loads path
            if (*p == '-') p++;
            if (p < end && (*p == 'I' || *p == 'N')) return fail(FB);
            if (p >= end || *p < '0' || *p > '9') return fail(INV);
            if (*p == '0') p++;
            else while (p < end && *p >= '0' && *p <= '9') p++;
            if (p < end && *p == '.') {
                p++;
                const char* d0 = p;
                while (p < end && *p >= '0' && *p <= '9') p++;
                if (p == d0) return fail(INV);
            }
            if (p < end && (*p == 'e' || *p == 'E')) {
                p++;
                if (p < end && (*p == '+' || *p == '-')) p++;
                const char* d0 = p;
                while (p < end && *p >= '0' && *p <= '9') p++;
                if (p == d0) return fail(INV);
            }
            v.e = p;
            return true;
        }
        if (c == 'N' || c == 'I') return fail(FB);
        return fail(INV);
    }
};

}  // namespace jscan
}  // anonymous namespace

// ------------------------------------------------- columnar ingest (tier 1)
//
// Single-pass columnar builder: the same JSON walk as the NDJSON lane
// above, but values land in typed Arrow-layout column buffers (float64 /
// bool / string+validity) DURING the one parse. The buffers export
// zero-copy across the ctypes boundary (values + validity bitmap + string
// offsets, Arrow physical layout exactly), so Python wraps them with
// pa.foreign_buffer / pa.Array.from_buffers and never re-tokenizes
// anything. The NDJSON lane stays as the second tier: any shape the
// builder can't represent exactly (mixed-type columns, escaped keys, lone
// surrogates, raw control chars) returns FALLBACK and the caller walks
// down the ladder with identical user-visible behavior.
//
// Numeric columns build as float64 directly: SchemaVersion::V1 stages every
// number as float64 anyway (the NDJSON lane's int64 columns get cast right
// after the reader), and decimal-string -> double parsing is correctly
// rounded, so the values are bit-identical to the Python path's float().

#include <atomic>
#include <map>

namespace {
namespace colb {

using jscan::Cur;
using jscan::Span;
using jscan::K_STR;
using jscan::K_NUM;
using jscan::K_TRUE;
using jscan::K_FALSE;
using jscan::K_NULL;
using jscan::kind_of;
using jscan::str_content;

enum { OK = PTPU_FJ_OK, FB = PTPU_FJ_FALLBACK, INV = PTPU_FJ_INVALID };

// Column kinds crossing the ABI (mirrored in native/__init__.py).
enum : int32_t {
    PT_COL_NULL = 0,     // no non-null value ever seen -> pa.nulls
    PT_COL_FLOAT64 = 1,  // f64 values
    PT_COL_BOOL = 2,     // bit-packed values (Arrow bool layout)
    PT_COL_STRING = 3,   // int32 offsets + utf8 chars
};

}  // namespace colb
}  // anonymous namespace

#include <locale.h>

namespace {
namespace colb {

// locale-independent double parse over a strict-JSON number token (the
// scanners above enforce the grammar, so the fallback strtod_l cannot
// under-consume). strtod_l dominated the whole-payload parse on numeric
// columns (~20% of flatten_columnar on a float-heavy body), so common
// shapes convert directly, with bit-exact results:
//
//   tier 1  <=15 significant digits, |10-exponent| <= 22: mantissa and
//           10^k are both exactly representable doubles, so the single
//           multiply/divide is correctly rounded (Gay's exact fast path).
//   tier 2  (x86-64 only) <=19 digits, |10-exponent| <= 27: one x87
//           80-bit op. m < 10^19 < 2^64 and 10^27 = 2^27*5^27 with
//           5^27 < 2^63 are both exact long doubles, so the result is
//           within 0.5 ulp(64) of the true value; converting down to
//           53 bits can then only disagree with correct rounding when
//           the 11 below-double bits sit on the halfway pattern 0x400 —
//           those (and a +/-2 comfort margin) fall through to strtod_l.
//           Exponent range keeps every tier-2 value in [1e-27, 1e46]:
//           no subnormal or overflow cases to special-case.
//   tier 3  strtod_l — authoritative for everything else (>19 digits,
//           big exponents, halfway-adjacent values).
static double parse_double_slow(const char* b, const char* e) {
    static locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
    char buf[64];
    size_t n = (size_t)(e - b);
    if (n < sizeof(buf)) {
        std::memcpy(buf, b, n);
        buf[n] = 0;
        return strtod_l(buf, nullptr, c_loc);
    }
    std::string tmp(b, e);
    return strtod_l(tmp.c_str(), nullptr, c_loc);
}

static double parse_double(const char* b, const char* e) {
    const char* p = b;
    bool neg = false;
    if (p < e && *p == '-') { neg = true; p++; }
    uint64_t m = 0;
    int nd = 0;        // significant digits accumulated into m
    int64_t e10 = 0;   // value = m * 10^e10 (exact unless truncated)
    bool truncated = false;
    while (p < e && *p >= '0' && *p <= '9') {
        if (m == 0 && *p == '0') { p++; continue; }  // leading zeros
        if (nd < 19) { m = m * 10 + (uint64_t)(*p - '0'); nd++; }
        else { e10++; truncated = true; }
        p++;
    }
    if (p < e && *p == '.') {
        p++;
        while (p < e && *p >= '0' && *p <= '9') {
            if (m == 0 && *p == '0') { e10--; p++; continue; }  // 0.000x
            if (nd < 19) { m = m * 10 + (uint64_t)(*p - '0'); nd++; e10--; }
            else truncated = true;
            p++;
        }
    }
    if (p < e && (*p == 'e' || *p == 'E')) {
        p++;
        bool en = false;
        if (p < e && (*p == '+' || *p == '-')) { en = (*p == '-'); p++; }
        int64_t ex = 0;
        while (p < e && *p >= '0' && *p <= '9') {
            if (ex < 1000000) ex = ex * 10 + (*p - '0');
            p++;
        }
        e10 += en ? -ex : ex;
    }
    if (m == 0) return neg ? -0.0 : 0.0;  // covers "0", "-0.0", "0e9"
    if (!truncated) {
        if (nd <= 15 && e10 >= -22 && e10 <= 22) {
            static const double p10[23] = {
                1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
            double d = (double)m;  // exact: m < 10^15 < 2^53
            d = e10 >= 0 ? d * p10[e10] : d / p10[-e10];
            return neg ? -d : d;
        }
#if defined(__x86_64__) && defined(__SIZEOF_LONG_DOUBLE__) && (LDBL_MANT_DIG == 64)
        if (e10 >= -27 && e10 <= 27) {
            static const long double lp10[28] = {
                1e0L,  1e1L,  1e2L,  1e3L,  1e4L,  1e5L,  1e6L,
                1e7L,  1e8L,  1e9L,  1e10L, 1e11L, 1e12L, 1e13L,
                1e14L, 1e15L, 1e16L, 1e17L, 1e18L, 1e19L, 1e20L,
                1e21L, 1e22L, 1e23L, 1e24L, 1e25L, 1e26L, 1e27L};
            long double ld = (long double)m;  // exact: m < 10^19 < 2^64
            ld = e10 >= 0 ? ld * lp10[e10] : ld / lp10[-e10];
            uint64_t m64;
            std::memcpy(&m64, &ld, 8);  // x87 layout: low 8 bytes = mantissa
            uint32_t r = (uint32_t)(m64 & 0x7FF);
            if (r < 0x3FE || r > 0x402) {
                double d = (double)ld;
                return neg ? -d : d;
            }
        }
#endif
    }
    return parse_double_slow(b, e);
}

// strict UTF-8 validation (surrogate and overlong rejecting): column chars
// become Python str / Arrow utf8, which both require validity — the Python
// json path would have raised its own error on undecodable payload bytes.
static bool valid_utf8(const char* b, const char* e) {
    const unsigned char* p = (const unsigned char*)b;
    const unsigned char* q = (const unsigned char*)e;
    while (p < q) {
        unsigned char c = *p;
        if (c < 0x80) { p++; continue; }
        int cont;
        unsigned char lo = 0x80, hi = 0xBF;
        if (c >= 0xC2 && c <= 0xDF) cont = 1;
        else if (c == 0xE0) { cont = 2; lo = 0xA0; }
        else if (c >= 0xE1 && c <= 0xEC) cont = 2;
        else if (c == 0xED) { cont = 2; hi = 0x9F; }  // no surrogates
        else if (c >= 0xEE && c <= 0xEF) cont = 2;
        else if (c == 0xF0) { cont = 3; lo = 0x90; }
        else if (c >= 0xF1 && c <= 0xF3) cont = 3;
        else if (c == 0xF4) { cont = 3; hi = 0x8F; }
        else return false;  // C0/C1 overlong lead or F5+.
        if (q - p <= cont) return false;
        if (p[1] < lo || p[1] > hi) return false;
        for (int i = 2; i <= cont; i++)
            if (p[i] < 0x80 || p[i] > 0xBF) return false;
        p += cont + 1;
    }
    return true;
}

static void append_cp_utf8(std::string& dst, unsigned cp) {
    if (cp < 0x80) {
        dst += (char)cp;
    } else if (cp < 0x800) {
        dst += (char)(0xC0 | (cp >> 6));
        dst += (char)(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
        dst += (char)(0xE0 | (cp >> 12));
        dst += (char)(0x80 | ((cp >> 6) & 0x3F));
        dst += (char)(0x80 | (cp & 0x3F));
    } else {
        dst += (char)(0xF0 | (cp >> 18));
        dst += (char)(0x80 | ((cp >> 12) & 0x3F));
        dst += (char)(0x80 | ((cp >> 6) & 0x3F));
        dst += (char)(0x80 | (cp & 0x3F));
    }
}

static int hex_nibble(char c) {
    if (c >= '0' && c <= '9') return c - '0';
    if (c >= 'a' && c <= 'f') return c - 'a' + 10;
    if (c >= 'A' && c <= 'F') return c - 'A' + 10;
    return -1;
}

static int parse_u16(const char* s, const char* e) {
    if (e - s < 4) return -1;
    int v = 0;
    for (int i = 0; i < 4; i++) {
        int n = hex_nibble(s[i]);
        if (n < 0) return -1;
        v = (v << 4) | n;
    }
    return v;
}

// Unescape JSON string content [s,e) (between the quotes) into dst.
// Returns false — the caller declines to the NDJSON/Python tiers — on:
// raw control chars (invalid JSON; Python raises), invalid \u sequences,
// LONE SURROGATES (Python's json accepts them but the resulting str can't
// encode to Arrow utf8 — the Python path owns that error), bad escapes,
// and invalid UTF-8 in the raw segments.
static bool unescape_append(const char* s, const char* e, std::string& dst) {
    while (s < e) {
        const char* bs = (const char*)std::memchr(s, '\\', (size_t)(e - s));
        const char* seg = bs ? bs : e;
        for (const char* t = s; t < seg; t++)
            if ((unsigned char)*t < 0x20) return false;
        if (!valid_utf8(s, seg)) return false;
        dst.append(s, (size_t)(seg - s));
        if (bs == nullptr) return true;
        s = bs + 1;
        if (s >= e) return false;
        char c = *s++;
        switch (c) {
            case '"': dst += '"'; break;
            case '\\': dst += '\\'; break;
            case '/': dst += '/'; break;
            case 'b': dst += '\b'; break;
            case 'f': dst += '\f'; break;
            case 'n': dst += '\n'; break;
            case 'r': dst += '\r'; break;
            case 't': dst += '\t'; break;
            case 'u': {
                int u1 = parse_u16(s, e);
                if (u1 < 0) return false;
                s += 4;
                if (u1 >= 0xD800 && u1 <= 0xDBFF) {
                    if (e - s < 6 || s[0] != '\\' || s[1] != 'u') return false;
                    int u2 = parse_u16(s + 2, e);
                    if (u2 < 0xDC00 || u2 > 0xDFFF) return false;
                    s += 6;
                    unsigned cp = 0x10000u + (((unsigned)(u1 - 0xD800)) << 10)
                                  + (unsigned)(u2 - 0xDC00);
                    append_cp_utf8(dst, cp);
                } else if (u1 >= 0xDC00 && u1 <= 0xDFFF) {
                    return false;  // lone low surrogate
                } else {
                    append_cp_utf8(dst, (unsigned)u1);
                }
                break;
            }
            default:
                return false;
        }
    }
    return true;
}

static inline void bm_push(std::vector<uint8_t>& bm, uint64_t idx, bool v) {
    if ((idx & 7) == 0) bm.push_back(0);
    if (v) bm[idx >> 3] |= (uint8_t)(1u << (idx & 7));
}

struct ColBuilder {
    std::string name;
    int32_t kind = PT_COL_NULL;
    uint64_t rows = 0;        // values appended so far (incl. nulls)
    uint64_t null_count = 0;
    std::vector<uint8_t> validity;  // Arrow validity bitmap, LSB-first
    std::vector<double> f64;
    std::vector<uint8_t> bits;      // bool values bitmap
    std::vector<int32_t> offsets;   // string offsets (rows + 1)
    std::string chars;              // string data (raw utf8, unescaped)
};

// Columns fill positionally (uniform key sets, like the NDJSON tier).
// Every add_* returns false when the shape needs a lower tier: a value
// landing in an already-filled column (duplicate key in one row) or a
// kind mismatch (mixed-type column).
struct ColumnarBatch {
    std::vector<ColBuilder> cols;
    std::map<std::string, uint32_t, std::less<>> index;
    uint64_t nrows = 0;  // completed rows

    int64_t find_col(std::string_view name) const {
        auto it = index.find(name);
        return it == index.end() ? -1 : (int64_t)it->second;
    }

    uint32_t create(std::string_view name) {
        cols.emplace_back();
        ColBuilder& c = cols.back();
        c.name.assign(name);
        for (uint64_t r = 0; r < nrows; r++) bm_push(c.validity, r, false);
        c.null_count = nrows;
        c.rows = nrows;
        uint32_t i = (uint32_t)(cols.size() - 1);
        index.emplace(c.name, i);
        return i;
    }

    bool set_kind(ColBuilder& c, int32_t k) {
        if (c.kind == k) return true;
        if (c.kind != PT_COL_NULL) return false;  // mixed-type column
        c.kind = k;
        switch (k) {  // backfill typed storage for the null prefix
            case PT_COL_FLOAT64: c.f64.assign(c.rows, 0.0); break;
            case PT_COL_BOOL:
                for (uint64_t r = 0; r < c.rows; r++) bm_push(c.bits, r, false);
                break;
            case PT_COL_STRING: c.offsets.assign(c.rows + 1, 0); break;
            default: break;
        }
        return true;
    }

    bool add_null(ColBuilder& c) {
        if (c.rows != nrows) return false;
        bm_push(c.validity, c.rows, false);
        c.null_count++;
        switch (c.kind) {
            case PT_COL_FLOAT64: c.f64.push_back(0.0); break;
            case PT_COL_BOOL: bm_push(c.bits, c.rows, false); break;
            case PT_COL_STRING: c.offsets.push_back(c.offsets.back()); break;
            default: break;
        }
        c.rows++;
        return true;
    }

    bool add_f64(ColBuilder& c, double v) {
        if (c.rows != nrows || !set_kind(c, PT_COL_FLOAT64)) return false;
        bm_push(c.validity, c.rows, true);
        c.f64.push_back(v);
        c.rows++;
        return true;
    }

    bool add_bool(ColBuilder& c, bool v) {
        if (c.rows != nrows || !set_kind(c, PT_COL_BOOL)) return false;
        bm_push(c.validity, c.rows, true);
        bm_push(c.bits, c.rows, v);
        c.rows++;
        return true;
    }

    // escaped JSON content -> unescape straight into the column chars
    bool add_str_unescape(ColBuilder& c, const char* b, const char* e) {
        if (c.rows != nrows || !set_kind(c, PT_COL_STRING)) return false;
        if (!unescape_append(b, e, c.chars)) return false;
        if (c.chars.size() > (size_t)INT32_MAX) return false;
        bm_push(c.validity, c.rows, true);
        c.offsets.push_back((int32_t)c.chars.size());
        c.rows++;
        return true;
    }

    // close the row: any column this row didn't touch gets null
    bool end_row() {
        for (auto& c : cols)
            if (c.rows == nrows && !add_null(c)) return false;
        nrows++;
        return true;
    }
};

// ---- plain-JSON lane: flatten straight to columns -------------------------
//
// Mirrors FlattenCtx exactly — same depth limit, same key-set uniformity
// (positional match against record 0), same declines (arrays, sparse or
// reordered or duplicate keys, NaN/Infinity, non-object records, empty
// records) — plus the columnar-only declines (escaped keys, mixed-type
// columns, invalid UTF-8). Every decline lands on the NDJSON tier first,
// which re-decides with its own (identical or looser) rules.
struct JsonColCtx {
    Cur c;
    ColumnarBatch b;
    int max_depth;
    const char* sep;
    size_t seplen;
    uint64_t nrec = 0;
    size_t key_pos = 0;
    int rc = OK;

    bool fail(int code) { rc = code; return false; }

    bool leaf(const std::string& name, const Span& v) {
        uint32_t ci;
        if (nrec == 0) {
            int64_t found = b.find_col(name);
            if (found >= 0) {
                ci = (uint32_t)found;  // duplicate key: add_* below declines
            } else {
                if (!valid_utf8(name.data(), name.data() + name.size()))
                    return fail(FB);
                ci = b.create(name);
            }
        } else {
            if (key_pos >= b.cols.size()) return fail(FB);  // extra key
            if (b.cols[key_pos].name != name) return fail(FB);  // sparse/reordered
            ci = (uint32_t)key_pos;
        }
        key_pos++;
        ColBuilder& col = b.cols[ci];
        bool ok;
        switch (kind_of(v)) {
            case K_STR: {
                Span sc = str_content(v);
                ok = b.add_str_unescape(col, sc.b, sc.e);
                break;
            }
            case K_NUM: ok = b.add_f64(col, parse_double(v.b, v.e)); break;
            case K_TRUE: ok = b.add_bool(col, true); break;
            case K_FALSE: ok = b.add_bool(col, false); break;
            case K_NULL: ok = b.add_null(col); break;
            default: return fail(INV);
        }
        return ok ? true : fail(FB);
    }

    bool flatten_obj(std::string& prefix, int depth) {
        if (depth > max_depth) return fail(FB);
        if (c.p >= c.end || *c.p != '{') return fail(INV);
        c.p++;
        c.ws();
        if (c.p < c.end && *c.p == '}') { c.p++; return true; }
        while (true) {
            c.ws();
            Span k;
            if (!c.str_span(k)) return fail(c.rc);
            Span kc = str_content(k);
            if (kc.len() && std::memchr(kc.b, '\\', kc.len()) != nullptr)
                return fail(FB);  // escaped key: NDJSON tier handles
            c.ws();
            if (c.p >= c.end || *c.p != ':') return fail(INV);
            c.p++;
            c.ws();
            size_t plen = prefix.size();
            if (plen) prefix.append(sep, seplen);
            prefix.append(kc.b, kc.len());
            if (c.p < c.end && *c.p == '{') {
                if (!flatten_obj(prefix, depth + 1)) return false;
            } else if (c.p < c.end && *c.p == '[') {
                return fail(FB);  // array semantics: lower tiers
            } else {
                Span v;
                if (!c.scalar_span(v)) return fail(c.rc);
                if (!leaf(prefix, v)) return false;
            }
            prefix.resize(plen);
            c.ws();
            if (c.p < c.end && *c.p == ',') { c.p++; continue; }
            if (c.p < c.end && *c.p == '}') { c.p++; return true; }
            return fail(INV);
        }
    }

    bool record() {
        c.ws();
        if (c.p >= c.end || *c.p != '{') return fail(FB);  // non-object element
        key_pos = 0;
        std::string prefix;
        if (!flatten_obj(prefix, 1)) return false;
        if (key_pos == 0) return fail(FB);  // empty record
        if (nrec > 0 && key_pos != b.cols.size()) return fail(FB);  // sparse
        if (!b.end_row()) return fail(FB);
        nrec++;
        return true;
    }

    bool run() {
        c.ws();
        if (c.p >= c.end) return fail(INV);
        if (*c.p == '[') {
            c.p++;
            c.ws();
            if (c.p < c.end && *c.p == ']') { c.p++; }
            else {
                while (true) {
                    if (!record()) return false;
                    c.ws();
                    if (c.p < c.end && *c.p == ',') { c.p++; continue; }
                    if (c.p < c.end && *c.p == ']') { c.p++; break; }
                    return fail(INV);
                }
            }
        } else if (*c.p == '{') {
            if (!record()) return false;
        } else {
            return fail(FB);
        }
        c.ws();
        if (c.p != c.end) return fail(INV);
        return true;
    }

    // One shard's slice of a JSON-array payload: `record (, record)*`,
    // ending exactly at the slice end. Shard 0 additionally consumes the
    // leading `[`; the last shard consumes the closing `]`. The boundary
    // scan is optimistic — a split landing inside a string or nested value
    // makes some shard fail (str_span finds no unescaped close quote before
    // the slice end, or the record parse trips on the orphaned bytes), and
    // the caller reruns single-shard, which is authoritative.
    bool run_records(bool open_bracket, bool close_bracket) {
        c.ws();
        if (open_bracket) {
            if (c.p >= c.end || *c.p != '[') return fail(FB);
            c.p++;
        }
        while (true) {
            if (!record()) return false;
            c.ws();
            if (c.p < c.end && *c.p == ',') { c.p++; continue; }
            if (close_bracket) {
                if (c.p >= c.end || *c.p != ']') return fail(INV);
                c.p++;
                c.ws();
            }
            if (c.p != c.end) return fail(INV);
            return true;
        }
    }
};

}  // namespace colb
}  // anonymous namespace

// outstanding columnar results (leak detector: ptpu_cols_live)
static std::atomic<long long> g_cols_live{0};

// publish a finished batch behind an owning handle
static int ptpu_publish_cols(colb::ColumnarBatch&& b, void** out) {
    auto* h = new colb::ColumnarBatch(std::move(b));
    g_cols_live.fetch_add(1, std::memory_order_relaxed);
    *out = h;
    return PTPU_FJ_OK;
}

extern "C" {

// Parse+flatten a plain-JSON ingest payload straight into Arrow-layout
// column buffers. Returns PTPU_FJ_OK with an opaque handle in *out (read
// via the ptpu_cols_* accessors, release with ptpu_cols_free),
// PTPU_FJ_FALLBACK when the payload needs a lower tier, or
// PTPU_FJ_INVALID for malformed JSON.
int ptpu_flatten_columnar(const char* in, uint64_t len, int max_depth,
                          const char* sep, void** out) {
    colb::JsonColCtx ctx;
    ctx.c = colb::Cur{in, in + len};
    ctx.max_depth = max_depth;
    ctx.sep = sep;
    ctx.seplen = std::strlen(sep);
    if (!ctx.run()) return ctx.rc == colb::OK ? PTPU_FJ_FALLBACK : ctx.rc;
    return ptpu_publish_cols(std::move(ctx.b), out);
}

// The per-column accessors are bound-checked: they are called O(ncols) per
// batch, never per row, so the check is free; out-of-range reads return
// the same null/zero values an absent buffer does.
static inline const colb::ColBuilder* cols_at(void* h, uint32_t i) {
    if (h == nullptr) return nullptr;
    auto* b = (colb::ColumnarBatch*)h;
    return i < b->cols.size() ? &b->cols[i] : nullptr;
}

uint64_t ptpu_cols_nrows(void* h) { return ((colb::ColumnarBatch*)h)->nrows; }

uint32_t ptpu_cols_ncols(void* h) {
    return (uint32_t)((colb::ColumnarBatch*)h)->cols.size();
}

const char* ptpu_cols_name(void* h, uint32_t i) {
    const colb::ColBuilder* c = cols_at(h, i);
    return c ? c->name.c_str() : nullptr;
}

int32_t ptpu_cols_kind(void* h, uint32_t i) {
    const colb::ColBuilder* c = cols_at(h, i);
    return c ? c->kind : colb::PT_COL_NULL;
}

uint64_t ptpu_cols_null_count(void* h, uint32_t i) {
    const colb::ColBuilder* c = cols_at(h, i);
    return c ? c->null_count : 0;
}

const uint8_t* ptpu_cols_validity(void* h, uint32_t i) {
    const colb::ColBuilder* cp = cols_at(h, i);
    if (cp == nullptr) return nullptr;
    const auto& c = *cp;
    return c.validity.empty() ? nullptr : c.validity.data();
}

const uint8_t* ptpu_cols_data(void* h, uint32_t i) {
    const colb::ColBuilder* cp = cols_at(h, i);
    if (cp == nullptr) return nullptr;
    const auto& c = *cp;
    switch (c.kind) {
        case colb::PT_COL_FLOAT64: return (const uint8_t*)c.f64.data();
        case colb::PT_COL_BOOL: return c.bits.data();
        case colb::PT_COL_STRING: return (const uint8_t*)c.chars.data();
        default: return nullptr;
    }
}

uint64_t ptpu_cols_data_len(void* h, uint32_t i) {
    const colb::ColBuilder* cp = cols_at(h, i);
    if (cp == nullptr) return 0;
    const auto& c = *cp;
    switch (c.kind) {
        case colb::PT_COL_FLOAT64: return c.f64.size() * 8;
        case colb::PT_COL_BOOL: return c.bits.size();
        case colb::PT_COL_STRING: return c.chars.size();
        default: return 0;
    }
}

const int32_t* ptpu_cols_offsets(void* h, uint32_t i) {
    const colb::ColBuilder* cp = cols_at(h, i);
    if (cp == nullptr) return nullptr;
    const auto& c = *cp;
    return c.kind == colb::PT_COL_STRING ? c.offsets.data() : nullptr;
}

void ptpu_cols_free(void* h) {
    if (h == nullptr) return;
    delete (colb::ColumnarBatch*)h;
    g_cols_live.fetch_sub(1, std::memory_order_relaxed);
}

long long ptpu_cols_live(void) {
    return g_cols_live.load(std::memory_order_relaxed);
}

}  // extern "C"

// ------------------------------- sharded parse -----------------------------
//
// Multi-core ingest: split the payload at record boundaries, parse each
// slice on a native worker pool into its own ColumnarBatch, then stitch the
// parts back in payload order into ONE contiguous batch behind the same
// ptpu_cols_* handle. The split is OPTIMISTIC — a boundary landing inside a
// string or nested value makes some shard's parse fail, and the caller
// reruns single-shard, which is authoritative for rc AND result. Sharded
// success is byte-identical to unsharded success: per-shard builders apply
// the same per-record rules, and the stitch completes the cross-shard
// checks (positional name equality, kind agreement).

#include <condition_variable>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>

namespace {
namespace ppool {

// Native parse worker pool (lock-id: ppool::g_mu). Lazily started by the
// first sharded parse and restartable after shutdown: the server's stop
// drains it, a later call just re-spawns workers under the same lock.
// All four objects are intentionally leaked (never destroyed): a process
// exiting without ptpu_parse_pool_shutdown would otherwise run the static
// destructor of a vector of JOINABLE std::threads, which is
// std::terminate. Idle workers parked on g_cv die with the process.
std::mutex& g_mu = *new std::mutex;
std::condition_variable& g_cv = *new std::condition_variable;        // guarded-by: g_mu
std::deque<std::function<void()>>& g_jobs =
    *new std::deque<std::function<void()>>;                          // guarded-by: g_mu
std::vector<std::thread>& g_workers = *new std::vector<std::thread>; // guarded-by: g_mu
bool g_stopping = false;                                             // guarded-by: g_mu

void worker_main() {
    for (;;) {
        std::function<void()> job;
        {
            std::unique_lock<std::mutex> lk(g_mu);
            g_cv.wait(lk, [] { return g_stopping || !g_jobs.empty(); });
            if (g_jobs.empty()) return;  // stopping, queue drained
            job = std::move(g_jobs.front());
            g_jobs.pop_front();
        }
        job();
    }
}

// per-call completion latch: the submitting thread parses shard 0 itself
// (ctypes released the GIL for the whole call) and then blocks here
struct Latch {
    std::mutex mu;
    std::condition_variable cv;
    int remaining;  // guarded-by: mu
    explicit Latch(int n) : remaining(n) {}
    void count_down() {
        std::lock_guard<std::mutex> lk(mu);
        if (--remaining == 0) cv.notify_all();
    }
    void wait() {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return remaining == 0; });
    }
};

// run fn(1..n-1) on the pool and fn(0) inline; returns when all complete.
// Tops up (and un-stops) the pool under g_mu, so a shutdown racing a new
// request cannot strand queued jobs: either the old workers drain them
// (they exit only on stopping AND empty), or fresh workers are spawned.
template <typename Fn>
void run_sharded(int n, Fn&& fn) {
    if (n <= 1) {
        fn(0);
        return;
    }
    Latch latch(n - 1);
    {
        std::lock_guard<std::mutex> lk(g_mu);
        g_stopping = false;
        while ((int)g_workers.size() < n - 1) g_workers.emplace_back(worker_main);
        for (int i = 1; i < n; i++)
            g_jobs.emplace_back([i, &fn, &latch] {
                fn(i);
                latch.count_down();
            });
    }
    g_cv.notify_all();
    fn(0);
    latch.wait();
}

void shutdown() {
    std::vector<std::thread> workers;
    {
        std::lock_guard<std::mutex> lk(g_mu);
        g_stopping = true;
        workers.swap(g_workers);
    }
    g_cv.notify_all();
    for (auto& w : workers) w.join();  // join outside the lock
}

int size() {
    std::lock_guard<std::mutex> lk(g_mu);
    return (int)g_workers.size();
}

}  // namespace ppool
}  // anonymous namespace

namespace {
namespace colb {

enum { PTPU_MAX_SHARDS = 16 };

// Find up to nshards-1 record-boundary split points in a JSON-array
// payload: a ',' whose previous non-ws byte is '}' and next non-ws byte is
// '{', scanned forward from evenly spaced byte targets. Purely optimistic —
// false positives (the pattern inside a string) just fail a shard later.
static bool shard_boundaries(const char* in, uint64_t len, int nshards,
                             std::vector<uint64_t>& cuts) {
    const char* end = in + len;
    const char* p = in;
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
    if (p >= end || *p != '[') return false;  // single-object / other shapes
    uint64_t prev = (uint64_t)(p - in) + 1;
    for (int k = 1; k < nshards; k++) {
        uint64_t target = len * (uint64_t)k / (uint64_t)nshards;
        if (target <= prev) target = prev + 1;
        if (target >= len) break;
        const char* q = in + target;
        const char* hit = nullptr;
        while (q < end) {
            q = (const char*)std::memchr(q, ',', (size_t)(end - q));
            if (q == nullptr) break;
            const char* r = q - 1;
            while (r > in && (*r == ' ' || *r == '\t' || *r == '\n' || *r == '\r'))
                r--;
            if (*r == '}') {
                const char* f = q + 1;
                while (f < end &&
                       (*f == ' ' || *f == '\t' || *f == '\n' || *f == '\r'))
                    f++;
                if (f < end && *f == '{') {
                    hit = q;
                    break;
                }
            }
            q++;
        }
        if (hit == nullptr) break;  // tail has no more boundaries
        cuts.push_back((uint64_t)(hit - in));
        prev = (uint64_t)(hit - in) + 1;
    }
    return !cuts.empty();
}

// ---- ordered stitch -------------------------------------------------------

// append n bits of src's LSB-first bitmap onto dst (current length
// dst_rows bits); byte-aligned fast path copies whole bytes — trailing
// bits of the last source byte are zero by bm_push construction
static void bm_append(std::vector<uint8_t>& dst, uint64_t dst_rows,
                      const std::vector<uint8_t>& src, uint64_t n) {
    if (n == 0) return;
    if ((dst_rows & 7) == 0) {
        dst.insert(dst.end(), src.begin(), src.begin() + (size_t)((n + 7) / 8));
        return;
    }
    for (uint64_t i = 0; i < n; i++)
        bm_push(dst, dst_rows + i, (src[(size_t)(i >> 3)] >> (i & 7)) & 1);
}

static void bm_append_zeros(std::vector<uint8_t>& bm, uint64_t start, uint64_t n) {
    for (uint64_t i = 0; i < n; i++) bm_push(bm, start + i, false);
}

// one all-null run of n rows (a NULL-kind source part)
static void stitch_nulls(ColBuilder& c, uint64_t n) {
    bm_append_zeros(c.validity, c.rows, n);
    c.null_count += n;
    switch (c.kind) {
        case PT_COL_FLOAT64: c.f64.insert(c.f64.end(), (size_t)n, 0.0); break;
        case PT_COL_BOOL: bm_append_zeros(c.bits, c.rows, n); break;
        case PT_COL_STRING:
            c.offsets.insert(c.offsets.end(), (size_t)n, c.offsets.back());
            break;
        default: break;
    }
    c.rows += n;
}

static bool stitch_part_col(ColBuilder& dst, const ColBuilder& src) {
    if (src.kind == PT_COL_NULL) {
        stitch_nulls(dst, src.rows);
        return true;
    }
    bm_append(dst.validity, dst.rows, src.validity, src.rows);
    dst.null_count += src.null_count;
    switch (dst.kind) {  // kinds verified equal in pass 1
        case PT_COL_FLOAT64:
            dst.f64.insert(dst.f64.end(), src.f64.begin(), src.f64.end());
            break;
        case PT_COL_BOOL:
            bm_append(dst.bits, dst.rows, src.bits, src.rows);
            break;
        case PT_COL_STRING: {
            if (dst.chars.size() + src.chars.size() > (size_t)INT32_MAX)
                return false;  // rerun unsharded -> same FB the add would hit
            int32_t rebase = (int32_t)dst.chars.size();
            dst.chars.append(src.chars);
            for (size_t j = 1; j < src.offsets.size(); j++)
                dst.offsets.push_back(rebase + src.offsets[j]);
            break;
        }
        default: break;
    }
    dst.rows += src.rows;
    return true;
}

// Stitch per-shard batches into one contiguous batch, in payload order.
// Every part must carry the identical column name sequence — the
// cross-shard completion of the record-0 uniformity rule. Kind
// disagreements fail -> the caller reruns unsharded, which reproduces the
// exact decline the ladder expects.
static bool stitch_parts(std::vector<ColumnarBatch>& parts, ColumnarBatch& out) {
    for (size_t p = 1; p < parts.size(); p++) {
        if (parts[p].cols.size() != parts[0].cols.size()) return false;
        for (size_t i = 0; i < parts[p].cols.size(); i++)
            if (parts[p].cols[i].name != parts[0].cols[i].name) return false;
    }
    for (const auto& c : parts[0].cols) out.create(c.name);
    for (size_t i = 0; i < out.cols.size(); i++) {
        int32_t k = PT_COL_NULL;
        for (const auto& part : parts) {
            int32_t pk = part.cols[i].kind;
            if (pk == PT_COL_NULL) continue;
            if (k == PT_COL_NULL) k = pk;
            else if (k != pk) return false;  // mixed-type across shards
        }
        if (!out.set_kind(out.cols[i], k)) return false;
    }
    for (size_t i = 0; i < out.cols.size(); i++)
        for (const auto& part : parts)
            if (!stitch_part_col(out.cols[i], part.cols[i])) return false;
    uint64_t total = 0;
    for (const auto& part : parts) total += part.nrows;
    out.nrows = total;
    return true;
}

}  // namespace colb
}  // anonymous namespace

extern "C" {

// Sharded variant of ptpu_flatten_columnar: nshards worker slices split at
// record boundaries, stitched in payload order. Identical observable
// behavior to the unsharded export at any shard count — any shard or
// stitch failure reruns single-shard, which is authoritative.
int ptpu_flatten_columnar_sharded(const char* in, uint64_t len, int max_depth,
                                  const char* sep, int nshards, void** out) {
    if (nshards > colb::PTPU_MAX_SHARDS) nshards = colb::PTPU_MAX_SHARDS;
    if (nshards > 1) {
        std::vector<uint64_t> cuts;
        if (colb::shard_boundaries(in, len, nshards, cuts)) {
            int n = (int)cuts.size() + 1;
            std::vector<colb::JsonColCtx> ctxs((size_t)n);
            std::vector<char> ok((size_t)n, 0);
            for (int i = 0; i < n; i++) {
                uint64_t sb = i == 0 ? 0 : cuts[(size_t)i - 1] + 1;
                uint64_t se = i == n - 1 ? len : cuts[(size_t)i];
                ctxs[(size_t)i].c = colb::Cur{in + sb, in + se};
                ctxs[(size_t)i].max_depth = max_depth;
                ctxs[(size_t)i].sep = sep;
                ctxs[(size_t)i].seplen = std::strlen(sep);
            }
            ppool::run_sharded(n, [&](int i) {
                ok[(size_t)i] = ctxs[(size_t)i].run_records(i == 0, i == n - 1) ? 1 : 0;
            });
            bool all_ok = true;
            for (int i = 0; i < n; i++) all_ok = all_ok && ok[(size_t)i];
            if (all_ok) {
                std::vector<colb::ColumnarBatch> parts;
                parts.reserve((size_t)n);
                for (auto& ctx : ctxs) parts.push_back(std::move(ctx.b));
                colb::ColumnarBatch stitched;
                if (colb::stitch_parts(parts, stitched))
                    return ptpu_publish_cols(std::move(stitched), out);
            }
        }
    }
    return ptpu_flatten_columnar(in, len, max_depth, sep, out);
}

// Drain and join the parse worker pool (the server's stop). Queued jobs
// complete first; the pool restarts lazily on the next sharded parse.
void ptpu_parse_pool_shutdown(void) { ppool::shutdown(); }

// live worker count (observability + tests)
int ptpu_parse_pool_size(void) { return ppool::size(); }

}  // extern "C"
