// Host-side parsers of libskylark_tpu_torch's readers (io/native.py): the
// two-pass libsvm and arc-list tokenizers, built by g++ into a shared
// library with a plain C interface and loaded with ctypes
// (kernels/build.py build_host). A copy of the JAX package's
// native/io_parsers.cpp, so the port never loads that package's library.
//
// Every function returns 0 on success, a small positive error code
// otherwise.
//
// Format semantics are those of the Python parsers in io/libsvm.py and
// io/arclist.py:
//   libsvm: blank or '#' line terminates; nt = leading no-':' tokens of the
//           first line; indices 1-based in file, 0-based out; d = max idx.
//   arc list: blank or '#' lines are skipped; "from to [weight]".

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Cursor {
    const char* p;
    const char* end;
    bool done() const { return p >= end; }
};

// Returns the [begin, end) of the next line and advances past it.
bool next_line(Cursor& c, const char*& lb, const char*& le) {
    if (c.done()) return false;
    lb = c.p;
    const char* nl = static_cast<const char*>(
        memchr(c.p, '\n', static_cast<size_t>(c.end - c.p)));
    if (nl == nullptr) {
        le = c.end;
        c.p = c.end;
    } else {
        le = nl;
        c.p = nl + 1;
    }
    // trim trailing \r and spaces
    while (le > lb && (le[-1] == '\r' || le[-1] == ' ' || le[-1] == '\t'))
        --le;
    // trim leading spaces
    while (lb < le && (*lb == ' ' || *lb == '\t')) ++lb;
    return true;
}

bool is_blank_or_comment(const char* lb, const char* le) {
    return lb >= le || *lb == '#';
}

// Advance over whitespace; return false at end of line.
bool skip_ws(const char*& p, const char* le) {
    while (p < le && (*p == ' ' || *p == '\t')) ++p;
    return p < le;
}

// Token = [p, q) of non-whitespace.
void token_end(const char* p, const char* le, const char*& q) {
    q = p;
    while (q < le && *q != ' ' && *q != '\t') ++q;
}

}  // namespace

extern "C" {

// Pass 1: count examples (n), targets (nt), max feature dim (d), total
// nonzeros (nnz). max_n < 0 means unlimited.
int sl_libsvm_count(const char* data, long long len,
                    long long* n_out, long long* nt_out,
                    long long* d_out, long long* nnz_out,
                    long long max_n) {
    Cursor c{data, data + len};
    long long n = 0, nt = -1, d = 0, nnz = 0;
    const char *lb, *le;
    while (next_line(c, lb, le)) {
        if (max_n >= 0 && n == max_n) break;
        if (is_blank_or_comment(lb, le)) break;  // terminates, per reference
        const char* p = lb;
        long long line_nt = 0;
        bool counting_nt = (nt < 0);
        while (skip_ws(p, le)) {
            const char* q;
            token_end(p, le, q);
            const char* colon = static_cast<const char*>(
                memchr(p, ':', static_cast<size_t>(q - p)));
            if (colon == nullptr) {
                if (counting_nt) ++line_nt;
                // otherwise: a label token (not counted again)
            } else {
                counting_nt = false;
                char* endp = nullptr;
                long long idx = strtoll(p, &endp, 10);
                if (endp != colon || idx < 1) return 2;  // malformed/0-based
                if (idx > d) d = idx;
                ++nnz;
            }
            p = q;
        }
        if (nt < 0) nt = line_nt;
        ++n;
    }
    if (nt < 0) nt = 0;
    *n_out = n;
    *nt_out = nt;
    *d_out = d;
    *nnz_out = nnz;
    return 0;
}

// Pass 2: fill Y (n*nt, row-major), rowptr (n+1), colind (nnz, 0-based),
// values (nnz). Caller allocates from pass-1 counts.
int sl_libsvm_fill(const char* data, long long len,
                   long long n, long long nt, long long nnz,
                   double* Y, long long* rowptr,
                   long long* colind, double* values) {
    Cursor c{data, data + len};
    const char *lb, *le;
    long long i = 0, k = 0;
    while (i < n && next_line(c, lb, le)) {
        if (is_blank_or_comment(lb, le)) break;
        rowptr[i] = k;
        const char* p = lb;
        long long t = 0;
        while (skip_ws(p, le)) {
            const char* q;
            token_end(p, le, q);
            const char* colon = static_cast<const char*>(
                memchr(p, ':', static_cast<size_t>(q - p)));
            char* endp = nullptr;
            if (colon == nullptr) {
                if (t >= nt) return 3;  // more labels than first line
                Y[i * nt + t] = strtod(p, &endp);
                if (endp == p) return 2;
                ++t;
            } else if (t < nt) {
                return 2;  // fewer labels than the first line declared —
                           // the Python parser rejects this line too
            } else {
                long long idx = strtoll(p, &endp, 10);
                if (endp != colon || idx < 1) return 2;
                double v = strtod(colon + 1, &endp);
                if (endp == colon + 1) return 2;
                if (k >= nnz) return 4;
                colind[k] = idx - 1;
                values[k] = v;
                ++k;
            }
            p = q;
        }
        ++i;
    }
    if (i != n || k != nnz) return 4;
    rowptr[n] = k;
    return 0;
}

// Arc list pass 1: count edges.
int sl_arclist_count(const char* data, long long len, long long* ne_out) {
    Cursor c{data, data + len};
    const char *lb, *le;
    long long ne = 0;
    while (next_line(c, lb, le)) {
        if (is_blank_or_comment(lb, le)) continue;  // skipped, per reference
        ++ne;
    }
    *ne_out = ne;
    return 0;
}

// Arc list pass 2: fill src/dst/w arrays (length ne). Weight defaults 1.
int sl_arclist_fill(const char* data, long long len, long long ne,
                    long long* src, long long* dst, double* w) {
    Cursor c{data, data + len};
    const char *lb, *le;
    long long e = 0;
    while (next_line(c, lb, le)) {
        if (is_blank_or_comment(lb, le)) continue;
        if (e >= ne) return 4;
        const char* p = lb;
        char* endp = nullptr;
        if (!skip_ws(p, le)) return 2;
        long long a = strtoll(p, &endp, 10);
        if (endp == p) return 2;
        p = endp;
        if (!skip_ws(p, le)) return 2;  // < 2 tokens
        long long b = strtoll(p, &endp, 10);
        if (endp == p) return 2;
        p = endp;
        double weight = 1.0;
        if (skip_ws(p, le)) {
            weight = strtod(p, &endp);
            if (endp == p) return 2;
        }
        src[e] = a;
        dst[e] = b;
        w[e] = weight;
        ++e;
    }
    if (e != ne) return 4;
    return 0;
}

}  // extern "C"
