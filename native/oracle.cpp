// Host-side scalar oracle for rapidfuzz_tpu.
//
// Independent, textbook implementations of every metric's *semantics* as
// documented in SURVEY.md (reference: /root/reference/src/distance/*.rs).
// These are intentionally simple O(N*M) / linear algorithms — a third
// opinion against both the reference (bit-parallel Rust) and the device
// kernels (batched bit-parallel JAX/Pallas), used for conformance testing
// and as the host fast path for tiny one-shot calls where device dispatch
// latency would dominate.
//
// Elements are int64 "hash keys" (equality-preserving encoding done by the
// Python codec). All functions return raw scores; cutoff algebra lives in
// Python (mirrors src/details/distance.rs which derives all score kinds
// from the raw metric).
//
// Build: g++ -O2 -shared -fPIC -o librf_oracle.so oracle.cpp

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

using std::int64_t;
using std::min;
using std::max;
using std::size_t;
using std::vector;

// ---------------------------------------------------------------- helpers
// Element-type templates: the int64 instantiation is the general "hash
// key" path; the uint8 instantiation is the raw str(kind-1)/bytes fast
// lane (no conversion, table checks fold away).  (Templates precede the
// extern "C" block — C linkage forbids them.)
template <typename C>
static size_t common_prefix(const C* a, size_t n1, const C* b, size_t n2) {
    size_t n = min(n1, n2), i = 0;
    while (i < n && a[i] == b[i]) i++;
    return i;
}

template <typename C>
static size_t common_suffix(const C* a, size_t n1, const C* b, size_t n2) {
    size_t n = min(n1, n2), i = 0;
    while (i < n && a[n1 - 1 - i] == b[n2 - 1 - i]) i++;
    return i;
}

// Strip common affix (suffix first, then prefix — semantics of
// src/details/common.rs:79-108; order only matters for which indices
// remain, not for any metric value).
template <typename C>
static void strip_affix(const C*& a, size_t& n1, const C*& b, size_t& n2) {
    size_t suf = common_suffix(a, n1, b, n2);
    n1 -= suf; n2 -= suf;
    size_t pre = common_prefix(a, n1, b, n2);
    a += pre; b += pre; n1 -= pre; n2 -= pre;
}

extern "C" {

// ------------------------------------------------------------ Levenshtein
int64_t rf_levenshtein_uniform(const int64_t* a, int64_t n1_,
                               const int64_t* b, int64_t n2_) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    strip_affix(a, n1, b, n2);
    if (n1 == 0) return (int64_t)n2;
    if (n2 == 0) return (int64_t)n1;
    vector<int64_t> row(n1 + 1);
    for (size_t i = 0; i <= n1; i++) row[i] = (int64_t)i;
    for (size_t j = 1; j <= n2; j++) {
        int64_t diag = row[0];
        row[0] = (int64_t)j;
        for (size_t i = 1; i <= n1; i++) {
            int64_t tmp = row[i];
            int64_t cost = (a[i - 1] == b[j - 1]) ? 0 : 1;
            row[i] = min(min(row[i] + 1, row[i - 1] + 1), diag + cost);
            diag = tmp;
        }
    }
    return row[n1];
}

// Banded Levenshtein DP: exact distance if it is <= band, else > band.
// Ukkonen band |i-j| <= band around the diagonal.
static int64_t lev_banded(const int64_t* a, size_t n1, const int64_t* b,
                          size_t n2, int64_t band) {
    if (n1 > n2) { std::swap(a, b); std::swap(n1, n2); }
    if ((int64_t)(n2 - n1) > band) return band + 1;
    int64_t INF = band + 1;
    // row over j in [i-band, i+band]
    size_t width = (size_t)(2 * band + 1);
    vector<int64_t> prev(width + 2, INF), cur(width + 2, INF);
    // prev[k] = D[i][j] where j = i - band + (k-1)
    for (size_t k = 1; k <= width; k++) {
        int64_t j = (int64_t)0 - band + (int64_t)(k - 1);
        if (j >= 0 && j <= (int64_t)n2) prev[k] = j;
    }
    for (size_t i = 1; i <= n1; i++) {
        for (size_t k = 0; k < width + 2; k++) cur[k] = INF;
        int64_t jlo = (int64_t)i - band, jhi = (int64_t)i + band;
        for (int64_t j = std::max<int64_t>(jlo, 0);
             j <= std::min<int64_t>(jhi, (int64_t)n2); j++) {
            size_t k = (size_t)(j - jlo + 1);
            if (j == 0) { cur[k] = (int64_t)i; continue; }
            int64_t cost = (a[i - 1] == b[j - 1]) ? 0 : 1;
            // D[i-1][j-1] -> prev[k]; D[i-1][j] -> prev[k+1]; D[i][j-1] -> cur[k-1]
            int64_t v = prev[k] + cost;
            if (prev[k + 1] < INF) v = min(v, prev[k + 1] + 1);
            if (cur[k - 1] < INF) v = min(v, cur[k - 1] + 1);
            cur[k] = min(v, INF);
        }
        std::swap(prev, cur);
    }
    int64_t j = (int64_t)n2, jlo = (int64_t)n1 - band;
    if (j < jlo || j > (int64_t)n1 + band) return INF;
    return prev[(size_t)(j - jlo + 1)];
}

// Exact uniform Levenshtein with band doubling (fast for long strings).
int64_t rf_levenshtein_uniform_banded(const int64_t* a, int64_t n1_,
                                      const int64_t* b, int64_t n2_) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    strip_affix(a, n1, b, n2);
    if (n1 == 0) return (int64_t)n2;
    if (n2 == 0) return (int64_t)n1;
    int64_t band = max<int64_t>(64, (int64_t)(n1 > n2 ? n1 - n2 : n2 - n1));
    int64_t lim = (int64_t)max(n1, n2);
    while (true) {
        int64_t d = lev_banded(a, n1, b, n2, band);
        if (d <= band || band >= lim) return d;
        band *= 2;
        if (band > lim) band = lim;
    }
}

// Weighted Levenshtein: delete a-element = del, insert b-element = ins,
// substitute = sub (generalized_wagner_fischer, levenshtein.rs:212-259).
int64_t rf_levenshtein_weighted(const int64_t* a, int64_t n1_,
                                const int64_t* b, int64_t n2_,
                                int64_t ins, int64_t del, int64_t sub) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    strip_affix(a, n1, b, n2);
    vector<int64_t> row(n1 + 1);
    for (size_t i = 0; i <= n1; i++) row[i] = (int64_t)i * del;
    for (size_t j = 1; j <= n2; j++) {
        int64_t diag = row[0];
        row[0] += ins;
        for (size_t i = 1; i <= n1; i++) {
            int64_t tmp = row[i];
            int64_t v;
            if (a[i - 1] == b[j - 1]) v = diag;
            else v = min(min(row[i - 1] + del, row[i] + ins), diag + sub);
            row[i] = v;
            diag = tmp;
        }
    }
    return row[n1];
}

// -------------------------------------------------------------------- LCS
int64_t rf_lcs_seq(const int64_t* a, int64_t n1_, const int64_t* b, int64_t n2_) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    // affix counts toward the LCS
    size_t suf = common_suffix(a, n1, b, n2);
    n1 -= suf; n2 -= suf;
    size_t pre = common_prefix(a, n1, b, n2);
    a += pre; b += pre; n1 -= pre; n2 -= pre;
    int64_t affix = (int64_t)(pre + suf);
    if (n1 == 0 || n2 == 0) return affix;
    vector<int64_t> row(n1 + 1, 0);
    for (size_t j = 1; j <= n2; j++) {
        int64_t diag = 0;
        for (size_t i = 1; i <= n1; i++) {
            int64_t tmp = row[i];
            if (a[i - 1] == b[j - 1]) row[i] = diag + 1;
            else row[i] = max(row[i], row[i - 1]);
            diag = tmp;
        }
    }
    return affix + row[n1];
}

int64_t rf_indel(const int64_t* a, int64_t n1, const int64_t* b, int64_t n2) {
    return n1 + n2 - 2 * rf_lcs_seq(a, n1, b, n2);
}

// -------------------------------------------------------------------- OSA
int64_t rf_osa(const int64_t* a, int64_t n1_, const int64_t* b, int64_t n2_) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    strip_affix(a, n1, b, n2);
    if (n1 == 0) return (int64_t)n2;
    if (n2 == 0) return (int64_t)n1;
    vector<int64_t> prev2(n1 + 1), prev(n1 + 1), cur(n1 + 1);
    for (size_t i = 0; i <= n1; i++) prev[i] = (int64_t)i;
    for (size_t j = 1; j <= n2; j++) {
        cur[0] = (int64_t)j;
        for (size_t i = 1; i <= n1; i++) {
            int64_t cost = (a[i - 1] == b[j - 1]) ? 0 : 1;
            int64_t v = min(min(cur[i - 1] + 1, prev[i] + 1), prev[i - 1] + cost);
            if (i > 1 && j > 1 && a[i - 1] == b[j - 2] && a[i - 2] == b[j - 1])
                v = min(v, prev2[i - 2] + 1);
            cur[i] = v;
        }
        prev2 = prev; prev = cur;
    }
    return prev[n1];
}

// --------------------------------------------- Damerau-Levenshtein (true)
// Lowrance-Wagner unrestricted transpositions.  Small pairs use the
// full-matrix formulation below; long pairs route to a rolling-row form
// whose transposition lookups read per-symbol row snapshots — memory
// O((sigma_a + 3) * M) instead of O(N * M), the role of the reference's
// Zhao-Sahni linear-space algorithm (damerau_levenshtein.rs:111-168),
// independently derived.
static int64_t damerau_rows(const int64_t* a, size_t n1, const int64_t* b,
                            size_t n2) {
    int64_t INF = (int64_t)(n1 + n2);
    // symbol ids over the union (da indexed by b's chars; cache by a's)
    vector<int64_t> syms(a, a + n1);
    syms.insert(syms.end(), b, b + n2);
    std::sort(syms.begin(), syms.end());
    syms.erase(std::unique(syms.begin(), syms.end()), syms.end());
    auto sym_id = [&](int64_t c) -> size_t {
        return (size_t)(std::lower_bound(syms.begin(), syms.end(), c)
                        - syms.begin());
    };
    vector<int64_t> da(syms.size(), 0);      // last row i' with a[i']==c
    // rows[c]: dp row (da[c] - 1), stored when row da[c] began
    vector<vector<int32_t>> rows(syms.size());
    vector<int32_t> prev(n2 + 1), cur(n2 + 1);
    for (size_t j = 0; j <= n2; j++) prev[j] = (int32_t)j;
    for (size_t i = 1; i <= n1; i++) {
        size_t ai = sym_id(a[i - 1]);
        vector<int32_t> snap = prev;         // dp row (i-1); installed
                                             // AFTER the row: k must be
                                             // the last row STRICTLY < i
        int64_t db = 0;                      // last col l<j with b[l]==a[i]
        cur[0] = (int32_t)i;
        for (size_t j = 1; j <= n2; j++) {
            int64_t k = da[sym_id(b[j - 1])];
            int64_t l = db;
            int64_t cost = 1;
            if (a[i - 1] == b[j - 1]) { cost = 0; db = (int64_t)j; }
            int64_t v = min<int64_t>(
                min<int64_t>(prev[j - 1] + cost, cur[j - 1] + 1),
                prev[j] + 1);
            if (k > 0 && l > 0) {
                const vector<int32_t>& rk = rows[sym_id(b[j - 1])];
                int64_t tr = (int64_t)rk[(size_t)(l - 1)]
                    + ((int64_t)i - k - 1) + 1 + ((int64_t)j - l - 1);
                v = min(v, tr);
            }
            cur[j] = (int32_t)min(v, INF);
        }
        rows[ai] = std::move(snap);
        da[ai] = (int64_t)i;
        std::swap(prev, cur);
    }
    return prev[n2];
}

// rolling-row variant exported for conformance tests (rf_damerau routes
// to it automatically for long inputs)
int64_t rf_damerau_rows(const int64_t* a, int64_t n1_, const int64_t* b,
                        int64_t n2_) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    strip_affix(a, n1, b, n2);
    if (n1 == 0) return (int64_t)n2;
    if (n2 == 0) return (int64_t)n1;
    return damerau_rows(a, n1, b, n2);
}

// Reusable buffers for the full-matrix Damerau (microsecond one-shot
// class: per-call vector allocations and the 135KB zero-init at len 128
// were ~half the call).
struct DamScratch {
    vector<int32_t> d;
    vector<int64_t> syms;
    vector<uint32_t> aid, bid;
    vector<int32_t> da;
};

static DamScratch& dam_scratch() {
    static thread_local DamScratch s;
    return s;
}

int64_t rf_damerau(const int64_t* a, int64_t n1_, const int64_t* b, int64_t n2_) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    strip_affix(a, n1, b, n2);
    if (n1 == 0) return (int64_t)n2;
    if (n2 == 0) return (int64_t)n1;
    if ((n1 + 2) * (n2 + 2) > (size_t)1 << 24)     // full matrix > ~64 MB
        return damerau_rows(a, n1, b, n2);
    DamScratch& ds = dam_scratch();
    int32_t INF = (int32_t)(n1 + n2);
    size_t C = n2 + 2;
    ds.d.resize((n1 + 2) * C);         // interior cells written row by row
    int32_t* d = ds.d.data();
    d[0] = INF;
    for (size_t i = 0; i <= n1; i++) {
        d[(i + 1) * C] = INF;
        d[(i + 1) * C + 1] = (int32_t)i;
    }
    for (size_t j = 0; j <= n2; j++) {
        d[j + 1] = INF;
        d[C + j + 1] = (int32_t)j;
    }

    // last row index (1-based) where each symbol occurred in `a`: a
    // direct 256-entry table when every char is small (the dominant
    // case), else ids via one sorted-unique pass (never per cell)
    ds.aid.resize(n1);
    ds.bid.resize(n2);
    size_t nsym;
    bool small = true;
    for (size_t i = 0; i < n1 && small; i++) small = (uint64_t)a[i] < 256;
    for (size_t j = 0; j < n2 && small; j++) small = (uint64_t)b[j] < 256;
    if (small) {
        for (size_t i = 0; i < n1; i++) ds.aid[i] = (uint32_t)a[i];
        for (size_t j = 0; j < n2; j++) ds.bid[j] = (uint32_t)b[j];
        nsym = 256;
    } else {
        vector<int64_t>& syms = ds.syms;
        syms.assign(a, a + n1);
        syms.insert(syms.end(), b, b + n2);
        std::sort(syms.begin(), syms.end());
        syms.erase(std::unique(syms.begin(), syms.end()), syms.end());
        nsym = syms.size();
        for (size_t i = 0; i < n1; i++)
            ds.aid[i] = (uint32_t)(std::lower_bound(syms.begin(),
                                                    syms.end(), a[i])
                                   - syms.begin());
        for (size_t j = 0; j < n2; j++)
            ds.bid[j] = (uint32_t)(std::lower_bound(syms.begin(),
                                                    syms.end(), b[j])
                                   - syms.begin());
    }
    ds.da.assign(nsym, 0);
    const uint32_t* aid = ds.aid.data();
    const uint32_t* bid = ds.bid.data();
    int32_t* da = ds.da.data();

    for (size_t i = 1; i <= n1; i++) {
        int32_t db = 0;                 // last col l<j with b[l]==a[i]
        const int32_t* up = d + i * C;  // matrix row i   (cell row i-1)
        int32_t* out = d + (i + 1) * C; // matrix row i+1 (cell row i)
        int64_t ac = a[i - 1];
        for (size_t j = 1; j <= n2; j++) {
            int32_t k = da[bid[j - 1]]; // last row < i with a[k]==b[j]
            int32_t l = db;
            int32_t cost = 1;
            if (ac == b[j - 1]) { cost = 0; db = (int32_t)j; }
            int32_t v = min(min(up[j] + cost,              // substitution
                                out[j] + 1),               // insertion
                            up[j + 1] + 1);                // deletion
            int32_t tr = d[(size_t)k * C + (size_t)l]      // transposition
                       + ((int32_t)i - k - 1) + 1 + ((int32_t)j - l - 1);
            out[j + 1] = min(v, tr);
        }
        da[aid[i - 1]] = (int32_t)i;
    }
    return d[(n1 + 1) * C + n2 + 1];
}

// ---------------------------------------------------------------- Hamming
// Padding semantics: overhang counts one mismatch per element
// (hamming.rs:138-161). Length equality enforcement lives in Python.
int64_t rf_hamming(const int64_t* a, int64_t n1, const int64_t* b, int64_t n2) {
    int64_t n = min(n1, n2), d = max(n1, n2) - n;
    for (int64_t i = 0; i < n; i++) d += (a[i] != b[i]);
    return d;
}

// ---------------------------------------------------------- prefix/postfix
int64_t rf_prefix_sim(const int64_t* a, int64_t n1, const int64_t* b, int64_t n2) {
    return (int64_t)common_prefix(a, (size_t)n1, b, (size_t)n2);
}
int64_t rf_postfix_sim(const int64_t* a, int64_t n1, const int64_t* b, int64_t n2) {
    return (int64_t)common_suffix(a, (size_t)n1, b, (size_t)n2);
}

// ------------------------------------------------------------------- Jaro
// Exact replication of the reference's match-assignment semantics
// (jaro.rs:422-514): window bound from the longer string, truncation of the
// longer string to shorter+bound, common prefix excluded from transposition
// counting, then per text char greedily claim the lowest unflagged matching
// pattern position inside the moving window.

// bit-parallel flagging fast path (defined with the BP kernels below);
// returns 1 and fills common_add/transpositions when it applies
static int jaro_try_bitflag(const int64_t* pa, size_t m, const int64_t* pb,
                            size_t t, size_t bound, size_t* common_add,
                            size_t* transpositions);

double rf_jaro(const int64_t* a, int64_t n1_, const int64_t* b, int64_t n2_) {
    size_t len1 = (size_t)n1_, len2 = (size_t)n2_;
    size_t o1 = len1, o2 = len2;
    if (o1 == 0 && o2 == 0) return 1.0;
    if (o1 == 0 || o2 == 0) return 0.0;
    if (o1 == 1 && o2 == 1) return (a[0] == b[0]) ? 1.0 : 0.0;

    size_t bound;
    if (len2 > len1) {
        bound = len2 / 2 - 1;
        if (len2 > len1 + bound) len2 = len1 + bound;
    } else {
        bound = len1 / 2 - 1;
        if (len1 > len2 + bound) len1 = len2 + bound;
    }

    size_t pre = common_prefix(a, len1, b, len2);
    size_t common = pre;
    const int64_t* pa = a + pre; size_t m = len1 - pre;   // pattern
    const int64_t* pb = b + pre; size_t t = len2 - pre;   // text
    size_t transpositions = 0;

    if (m != 0 && t != 0) {
        size_t cadd = 0;
        if (jaro_try_bitflag(pa, m, pb, t, bound, &cadd,
                             &transpositions)) {
            common += cadd;
        } else {
            vector<char> pflag(m, 0), tflag(t, 0);
            for (size_t j = 0; j < t; j++) {
                size_t lo = (j > bound) ? j - bound : 0;
                size_t hi = min(m, j + bound + 1);
                for (size_t i = lo; i < hi; i++) {
                    if (!pflag[i] && pa[i] == pb[j]) {
                        pflag[i] = 1; tflag[j] = 1; common++;
                        break;
                    }
                }
            }
            // transpositions: rank-matched flagged chars that differ
            vector<int64_t> fa, fb;
            for (size_t i = 0; i < m; i++) if (pflag[i]) fa.push_back(pa[i]);
            for (size_t j = 0; j < t; j++) if (tflag[j]) fb.push_back(pb[j]);
            for (size_t k = 0; k < fa.size(); k++)
                transpositions += (fa[k] != fb[k]);
        }
    }

    if (common == 0) return 0.0;
    size_t tr = transpositions / 2;
    double sim = (double)common / (double)o1
               + (double)common / (double)o2
               + ((double)common - (double)tr) / (double)common;
    return sim / 3.0;
}

// jaro_winkler.rs:64-101 (boost applied when jaro sim > 0.7)
double rf_jaro_winkler(const int64_t* a, int64_t n1, const int64_t* b, int64_t n2,
                       double prefix_weight) {
    int64_t maxp = min((int64_t)4, min(n1, n2));
    int64_t pre = 0;
    while (pre < maxp && a[pre] == b[pre]) pre++;
    double sim = rf_jaro(a, n1, b, n2);
    if (sim > 0.7) sim += (double)pre * prefix_weight * (1.0 - sim);
    return sim;
}

// --------------------------------------------------- batched convenience
// One-vs-many over a flat corpus (offsets[count+1] prefix array), for the
// host scalar fast path / BatchComparator CPU mode.
int64_t rf_levenshtein_uniform_bp(const int64_t* a, int64_t n1,
                                  const int64_t* b, int64_t n2,
                                  int64_t cutoff);
int64_t rf_indel_bp(const int64_t* a, int64_t n1, const int64_t* b,
                    int64_t n2);

void rf_levenshtein_uniform_1vN(const int64_t* q, int64_t nq,
                                const int64_t* flat, const int64_t* offsets,
                                int64_t count, int64_t* out) {
    for (int64_t i = 0; i < count; i++) {
        int64_t len = offsets[i + 1] - offsets[i];
        out[i] = (nq * len > 16384)
            ? rf_levenshtein_uniform_bp(q, nq, flat + offsets[i], len, -1)
            : rf_levenshtein_uniform(q, nq, flat + offsets[i], len);
    }
}

void rf_indel_1vN(const int64_t* q, int64_t nq,
                  const int64_t* flat, const int64_t* offsets,
                  int64_t count, int64_t* out) {
    for (int64_t i = 0; i < count; i++) {
        int64_t len = offsets[i + 1] - offsets[i];
        out[i] = (nq * len > 16384)
            ? rf_indel_bp(q, nq, flat + offsets[i], len)
            : rf_indel(q, nq, flat + offsets[i], len);
    }
}

// fuzz.partial_ratio (rapidfuzz-cpp semantics; absent from the crate,
// fuzz.rs:207-213): best indel ratio of the SHORTER string against every
// clipped window of the longer — windows longer[max(0, i - m) : min(n, i)]
// for i in 1..n+m-1.  Brute force per window via rf_indel; the f64 score
// uses the same 1 - dist/total expression as the library's host path so
// comparisons are bit-exact.
double rf_partial_ratio(const int64_t* a, int64_t n1,
                        const int64_t* b, int64_t n2) {
    const int64_t* s = a; int64_t ns = n1;
    const int64_t* l = b; int64_t nl = n2;
    if (n1 > n2) { s = b; ns = n2; l = a; nl = n1; }
    if (ns == 0) return nl == 0 ? 1.0 : 0.0;
    double best = -1.0;
    for (int64_t i = 1; i < nl + ns; i++) {
        int64_t st = i - ns > 0 ? i - ns : 0;
        int64_t en = i < nl ? i : nl;
        int64_t wlen = en - st;
        int64_t dist = rf_indel(s, ns, l + st, wlen);
        int64_t tot = ns + wlen;
        double r = 1.0 - (double)dist / (double)(tot > 0 ? tot : 1);
        if (r > best) best = r;
    }
    return best;
}

}  // extern "C"

// ======================================================================
// Bit-parallel (u64 blockwise) host kernels.
//
// The quadratic functions above stay as the textbook third opinion; these
// give the host scalar path the reference's one-shot asymptotics:
//   * uniform Levenshtein  O(ceil(K/64)*M), K = max(N, score_cutoff)
//     (Myers/Hyyro blockwise + Ukkonen band, levenshtein.rs:48-49,
//      1104-1222 semantics)
//   * LCS / indel          O(ceil(N/64)*M)  (Hyyro, lcs_seq.rs:199-261)
//   * OSA                  O(ceil(N/64)*M)  (Hyyro + transposition term,
//                                            osa.rs:84-227)
// The recurrences mirror the library's own device kernels
// (rapidfuzz_tpu/ops/{levenshtein,lcs,osa}.py, u32 lanes there) widened to
// u64 words.  Full-matrix sweeps are row-chunked (CHUNK_WORDS words of the
// pattern at a time): the per-chunk PM table and VP/VN state stay cache
// resident and memory is O(chunk + columns) regardless of input size, with
// per-column horizontal carries stored in boundary streams between chunks.

#include <cstdlib>

namespace {

constexpr size_t CHUNK_WORDS = 128;          // 8192 pattern rows per chunk

// open-addressed symbol -> dense id map (distinct count known <= capacity)
struct SymMap {
    vector<int64_t> keys;
    vector<int32_t> vals;
    size_t mask = 0;
    size_t n = 0;

    void init(size_t expected) {
        size_t cap = 64;
        while (cap < expected * 2) cap <<= 1;
        keys.assign(cap, 0);
        vals.assign(cap, -1);
        mask = cap - 1;
        n = 0;
    }
    static inline uint64_t hashk(int64_t k) {
        uint64_t x = (uint64_t)k;
        x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
        x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
        x ^= x >> 33;
        return x;
    }
    int32_t find(int64_t k) const {
        size_t i = hashk(k) & mask;
        while (vals[i] >= 0) {
            if (keys[i] == k) return vals[i];
            i = (i + 1) & mask;
        }
        return -1;
    }
    int32_t insert(int64_t k) {
        size_t i = hashk(k) & mask;
        while (vals[i] >= 0) {
            if (keys[i] == k) return vals[i];
            i = (i + 1) & mask;
        }
        keys[i] = k;
        vals[i] = (int32_t)n++;
        return vals[i];
    }
};

// PM table for pattern rows [r0, r1): pool[id*ww + w] has bit (i - r0) % 64
// set iff a[i] == symbol(id), w = (i - r0) / 64.
// Direct extended-ASCII PM table (pattern_match_vector.rs:67-155 shape:
// a [256] array fast path + hashmap overflow).  Worth the 2KB*ww memset
// only while the per-column hash find is a visible fraction of the word
// loop — i.e. small word counts (one-shot latency regime).
constexpr size_t DIRECT_MAX_WW = 8;            // direct path for m <= 512

static bool build_pm_chunk(const int64_t* a, size_t r0, size_t r1, size_t ww,
                           SymMap& sm, vector<uint64_t>& pool,
                           vector<uint64_t>& d256) {
    bool direct = ww <= DIRECT_MAX_WW;
    if (direct) {
        d256.assign(256 * ww, 0);
        bool all_small = true;
        for (size_t i = r0; i < r1; i++)
            if ((uint64_t)a[i] >= 256) { all_small = false; break; }
        if (all_small) {
            for (size_t i = r0; i < r1; i++)
                d256[(size_t)a[i] * ww + ((i - r0) >> 6)] |=
                    1ULL << ((i - r0) & 63);
            sm.init(1);                        // empty map: finds miss
            pool.clear();
            return true;
        }
    }
    sm.init(r1 - r0);
    pool.clear();
    for (size_t i = r0; i < r1; i++) {
        if (direct && (uint64_t)a[i] < 256) {
            d256[(size_t)a[i] * ww + ((i - r0) >> 6)] |=
                1ULL << ((i - r0) & 63);
            continue;
        }
        int32_t id = sm.insert(a[i]);
        if ((size_t)(id + 1) * ww > pool.size()) pool.resize((id + 1) * ww, 0);
        pool[(size_t)id * ww + ((i - r0) >> 6)] |= 1ULL << ((i - r0) & 63);
    }
    return direct;
}

// Per-column PM row lookup; nullptr means an all-zero row.
static inline const uint64_t* pm_find(bool direct, const SymMap& sm,
                                      const vector<uint64_t>& pool,
                                      const vector<uint64_t>& d256,
                                      size_t ww, int64_t key) {
    if (direct && (uint64_t)key < 256)
        return d256.data() + (uint64_t)key * ww;
    int32_t id = sm.find(key);
    return id >= 0 ? pool.data() + (size_t)id * ww : nullptr;
}

static inline bool all_small(const int64_t* a, size_t m) {
    for (size_t i = 0; i < m; i++)
        if ((uint64_t)a[i] >= 256) return false;
    return true;
}

// ---- 1-word (pattern <= 64 rows, chars < 256) specializations: PM in a
// stack table, no scratch machinery — the reference's dominant one-shot
// class (hyrroe2003 `levenshtein.rs:435-507`, `lcs_seq.rs:199-261` N=1,
// `osa.rs:84-135`).  Text chars >= 256 cannot match (PM row = 0).

// mbleven2018 tiny-cutoff short-circuit (the reference's dominant dedup
// configuration: levenshtein.rs:324-427, routed at cutoff < 4 from
// levenshtein.rs:1142-1144).  Op scripts are GENERATED (all length-k
// sequences over {sub, del, ins} whose net length delta equals m - n)
// instead of table-driven; each script is walked greedily and the best
// achieved cost wins.  Exact when the distance <= k, else returns k + 1.
// On typical text the greedy walks stop after <= k+1 mismatches, so a
// call costs tens of ops — no 2KB PM table, no 64-step word loop.
// Callers guarantee: affixes stripped, 1 <= k <= 3, m >= n, m - n <= k.
struct MblevenTable {
    // scripts[k][diff]: length-k op sequences, op 0=sub 1=del 2=ins,
    // with #del - #ins == diff.  Shorter scripts are subsumed: unused
    // trailing ops simply leave the greedy walk's cost lower.
    uint8_t ops[4][4][16][3];
    uint8_t cnt[4][4];
    MblevenTable() : ops(), cnt() {
        for (int k = 1; k <= 3; k++) {
            int total = 1;
            for (int i = 0; i < k; i++) total *= 3;
            for (int code = 0; code < total; code++) {
                uint8_t o[3] = {0, 0, 0};
                int c = code, nd = 0, ni = 0;
                for (int i = 0; i < k; i++) {
                    o[i] = (uint8_t)(c % 3);
                    c /= 3;
                    nd += o[i] == 1;
                    ni += o[i] == 2;
                }
                int delta = nd - ni;
                if (delta < 0 || delta > k) continue;
                uint8_t& ncur = cnt[k][delta];
                for (int i = 0; i < 3; i++)
                    ops[k][delta][ncur][i] = o[i];
                ncur++;
            }
        }
    }
};

template <typename C>
static int64_t lev_mbleven(const C* a, size_t m, const C* b,
                           size_t n, int64_t k) {
    static const MblevenTable T;
    size_t diff = m - n;
    int64_t best = k + 1;
    for (uint8_t s = 0; s < T.cnt[k][diff]; s++) {
        const uint8_t* ops = T.ops[k][diff][s];
        size_t i = 0, j = 0, c = 0;
        while (i < m && j < n) {
            if (a[i] != b[j]) {
                if (c >= (size_t)k) { c = (size_t)k + 1; break; }
                uint8_t op = ops[c++];
                i += op != 2;              // sub / del consume from a
                j += op != 1;              // sub / ins consume from b
            } else {
                i++;
                j++;
            }
        }
        if (c <= (size_t)k) {
            int64_t cost = (int64_t)(c + (m - i) + (n - j));
            if (cost < best) best = cost;
        }
        if (best == (int64_t)diff) break;  // length lower bound reached
    }
    return best;
}

// Indel/LCS tiny-cutoff short-circuit (the reference's dedup
// configuration for the LCS family: max_misses < 5 routes an op-table
// walk, lcs_seq.rs:488-532, table :113-133).  Same generated-script
// design as MblevenTable but ops come only from {del, ins} (LCS edits
// have no substitution), and because a length-j {del,ins} script fixes
// the parity of its delta, scripts of EVERY length <= 4 with the right
// delta are enumerated (padded with 0 = stop).  Exact when the indel
// distance <= k, else returns k + 1.  Callers guarantee: affixes
// stripped, 1 <= k <= 4, m >= n, m - n <= k.
struct IndelMblevenTable {
    uint8_t ops[5][5][16][4];    // [k][diff][script][pos]; 0 = stop
    uint8_t cnt[5][5];
    IndelMblevenTable() : ops(), cnt() {
        for (int k = 1; k <= 4; k++)
            for (int j = 1; j <= k; j++)
                for (int code = 0; code < (1 << j); code++) {
                    uint8_t o[4] = {0, 0, 0, 0};
                    int nd = 0, ni = 0;
                    for (int i = 0; i < j; i++) {
                        o[i] = (code >> i) & 1 ? 1 : 2;
                        nd += o[i] == 1;
                        ni += o[i] == 2;
                    }
                    int delta = nd - ni;
                    if (delta < 0 || delta > k) continue;
                    if (j < k && j + 2 <= k && delta <= k - 2)
                        continue;    // subsumed by a longer same-delta
                                     // script (append del+ins pairs)
                    uint8_t& ncur = cnt[k][delta];
                    for (int i = 0; i < 4; i++)
                        ops[k][delta][ncur][i] = o[i];
                    ncur++;
                }
    }
};

template <typename C>
static int64_t indel_mbleven(const C* a, size_t m, const C* b,
                             size_t n, int64_t k) {
    static const IndelMblevenTable T;
    size_t diff = m - n;
    int64_t best = k + 1;
    for (uint8_t s = 0; s < T.cnt[k][diff]; s++) {
        const uint8_t* ops = T.ops[k][diff][s];
        size_t i = 0, j = 0, c = 0;
        bool dead = false;
        while (i < m && j < n) {
            if (a[i] != b[j]) {
                if (c >= (size_t)k || c >= 4 || !ops[c]) {
                    dead = true;
                    break;
                }
                uint8_t op = ops[c++];
                i += op == 1;            // del consumes from a (longer)
                j += op == 2;            // ins consumes from b
            } else {
                i++;
                j++;
            }
        }
        if (!dead) {
            int64_t cost = (int64_t)(c + (m - i) + (n - j));
            if (cost <= k && cost < best) best = cost;
        }
        if (best == (int64_t)diff) break;    // length lower bound
    }
    return best;
}

// Clear only the PM entries the TEXT can read (a column loop never looks
// at pm[c] for chars absent from b, so entries left as garbage are
// harmless as long as every read entry was zeroed before the pattern
// inserts).  Kills the dominant fixed cost of the one-shot class — the
// 2-4KB table memset — whenever the text is shorter than the alphabet.
// Returns whether every text char fits the table (callers pick the
// unchecked column loop).
template <typename T, typename C>
static inline bool pm_clear(T* pm, const C* b, size_t n) {
    bool small = true;
    if (n < 256) {
        for (size_t j = 0; j < n; j++) {
            if ((uint64_t)b[j] < 256) pm[(size_t)b[j]] = 0;
            else small = false;
        }
    } else {
        memset(pm, 0, 256 * sizeof(T));
        for (size_t j = 0; j < n; j++) small &= (uint64_t)b[j] < 256;
    }
    return small;
}

template <typename C>
static int64_t lev_1w(const C* a, size_t m,
                      const C* b, size_t n) {
    uint64_t pm[256];
    bool bsmall = pm_clear(pm, b, n);
    for (size_t i = 0; i < m; i++) pm[a[i]] |= 1ULL << i;
    uint64_t VP = ~0ULL, VN = 0;
    uint64_t mask = 1ULL << (m - 1);
    int64_t dist = (int64_t)m;
    for (size_t j = 0; j < n; j++) {
        uint64_t x = bsmall ? pm[b[j]]
                            : ((uint64_t)b[j] < 256 ? pm[b[j]] : 0);
        uint64_t d0 = (((x & VP) + VP) ^ VP) | x | VN;
        uint64_t hp = VN | ~(d0 | VP);
        uint64_t hn = d0 & VP;
        dist += (int64_t)((hp & mask) != 0) - (int64_t)((hn & mask) != 0);
        uint64_t hp_s = (hp << 1) | 1;       // top boundary: D[0][j] = j
        uint64_t hn_s = hn << 1;
        VP = hn_s | ~(d0 | hp_s);
        VN = hp_s & d0;
    }
    return dist;
}

template <typename C>
static int64_t lcs_1w(const C* a, size_t m,
                      const C* b, size_t n) {
    uint64_t pm[256];
    bool bsmall = pm_clear(pm, b, n);
    for (size_t i = 0; i < m; i++) pm[a[i]] |= 1ULL << i;
    uint64_t S = ~0ULL;
    if (bsmall) {
        for (size_t j = 0; j < n; j++) {
            uint64_t u = S & pm[b[j]];
            S = (S + u) | (S - u);           // padding bits stay 1
        }
    } else {
        for (size_t j = 0; j < n; j++) {
            uint64_t u = S & ((uint64_t)b[j] < 256 ? pm[b[j]] : 0);
            S = (S + u) | (S - u);
        }
    }
    return (int64_t)__builtin_popcountll(~S);
}

template <typename C>
static int64_t osa_1w(const C* a, size_t m,
                      const C* b, size_t n) {
    uint64_t pm[256];
    bool bsmall = pm_clear(pm, b, n);
    for (size_t i = 0; i < m; i++) pm[a[i]] |= 1ULL << i;
    uint64_t VP = ~0ULL, VN = 0, D0P = 0, PMP = 0;
    uint64_t mask = 1ULL << (m - 1);
    int64_t dist = (int64_t)m;
    for (size_t j = 0; j < n; j++) {
        uint64_t pmw = bsmall ? pm[b[j]]
                              : ((uint64_t)b[j] < 256 ? pm[b[j]] : 0);
        uint64_t tr = ((~D0P & pmw) << 1) & PMP;
        uint64_t d0 = ((((pmw & VP) + VP) ^ VP) | pmw | VN) | tr;
        uint64_t hp = VN | ~(d0 | VP);
        uint64_t hn = d0 & VP;
        dist += (int64_t)((hp & mask) != 0) - (int64_t)((hn & mask) != 0);
        uint64_t hp_s = (hp << 1) | 1;
        uint64_t hn_s = hn << 1;
        VP = hn_s | ~(d0 | hp_s);
        VN = hp_s & d0;
        D0P = d0;
        PMP = pmw;
    }
    return dist;
}

// ---- 2-word (64 < m <= 128, chars < 256) specializations on native
// unsigned __int128: g++ lowers 128-bit + - & | ^ to add/adc register
// pairs, so a column costs roughly half the generic 2-word loop's
// explicit carry plumbing — the `lcs_unroll::<N>` monomorphization idea
// (lcs_seq.rs:199-261) taken to the ISA's natural wide integer.  This is
// the reference criterion charts' long end (len 2-128), where the r3
// scalar ladder sat ~2x above the published band.

typedef unsigned __int128 u128;

template <typename C>
static int64_t lcs_w_128(const C* a, size_t m,
                      const C* b, size_t n) {
    // explicit 2-word form: measured 356 ns vs 533 ns for the u128 form
    // at m=n=128 (the interleaved per-char 16-byte PM row plus the
    // independent word updates give more ILP than one 128-bit chain)
    u128 pm[256];
    bool bsmall = pm_clear(pm, b, n);
    for (size_t i = 0; i < m; i++) pm[a[i]] |= (u128)1 << i;
    uint64_t S0 = ~0ULL, S1 = ~0ULL;
    for (size_t j = 0; j < n; j++) {
        u128 row = bsmall ? pm[b[j]]
                          : ((uint64_t)b[j] < 256 ? pm[b[j]] : 0);
        uint64_t u0 = S0 & (uint64_t)row, u1 = S1 & (uint64_t)(row >> 64);
        uint64_t t0 = S0 + u0;
        uint64_t c = t0 < S0;
        uint64_t t1 = S1 + u1 + c;
        S0 = t0 | (S0 - u0);                 // padding bits stay 1
        S1 = t1 | (S1 - u1);
    }
    return (int64_t)(__builtin_popcountll(~S0)
                     + __builtin_popcountll(~S1));
}

template <typename C>
static int64_t lev_w_128(const C* a, size_t m,
                      const C* b, size_t n) {
    u128 pm[256];
    bool bsmall = pm_clear(pm, b, n);
    for (size_t i = 0; i < m; i++) pm[a[i]] |= (u128)1 << i;
    u128 VP = ~(u128)0, VN = 0;
    u128 mask = (u128)1 << (m - 1);
    int64_t dist = (int64_t)m;
    for (size_t j = 0; j < n; j++) {
        u128 x = bsmall ? pm[b[j]]
                        : ((uint64_t)b[j] < 256 ? pm[b[j]] : 0);
        u128 d0 = (((x & VP) + VP) ^ VP) | x | VN;
        u128 hp = VN | ~(d0 | VP);
        u128 hn = d0 & VP;
        dist += (int64_t)((hp & mask) != 0) - (int64_t)((hn & mask) != 0);
        u128 hp_s = (hp << 1) | 1;           // top boundary: D[0][j] = j
        u128 hn_s = hn << 1;
        VP = hn_s | ~(d0 | hp_s);
        VN = hp_s & d0;
    }
    return dist;
}

template <typename C>
static int64_t osa_w_128(const C* a, size_t m,
                      const C* b, size_t n) {
    u128 pm[256];
    bool bsmall = pm_clear(pm, b, n);
    for (size_t i = 0; i < m; i++) pm[a[i]] |= (u128)1 << i;
    u128 VP = ~(u128)0, VN = 0, D0P = 0, PMP = 0;
    u128 mask = (u128)1 << (m - 1);
    int64_t dist = (int64_t)m;
    for (size_t j = 0; j < n; j++) {
        u128 pmw = bsmall ? pm[b[j]]
                          : ((uint64_t)b[j] < 256 ? pm[b[j]] : 0);
        u128 tr = ((~D0P & pmw) << 1) & PMP;
        u128 d0 = ((((pmw & VP) + VP) ^ VP) | pmw | VN) | tr;
        u128 hp = VN | ~(d0 | VP);
        u128 hn = d0 & VP;
        dist += (int64_t)((hp & mask) != 0) - (int64_t)((hn & mask) != 0);
        u128 hp_s = (hp << 1) | 1;
        u128 hn_s = hn << 1;
        VP = hn_s | ~(d0 | hp_s);
        VN = hp_s & d0;
        D0P = d0;
        PMP = pmw;
    }
    return dist;
}

// ---- small-W (pattern <= 512 rows, chars < 256) specializations: PM and
// state on the stack, word loop unrolled at compile time — the
// `lcs_unroll::<N>` monomorphization idea (lcs_seq.rs:370-403) applied to
// all three bit-parallel metrics.  Dispatch picks W = ceil(m/64) exactly,
// so the score row always lives in word W-1.

template <size_t W>
static int64_t lev_w(const int64_t* a, size_t m,
                     const int64_t* b, size_t n) {
    uint64_t pm[256 * W];
    memset(pm, 0, sizeof(pm));
    for (size_t i = 0; i < m; i++)
        pm[(size_t)a[i] * W + (i >> 6)] |= 1ULL << (i & 63);
    uint64_t VP[W], VN[W];
    for (size_t w = 0; w < W; w++) { VP[w] = ~0ULL; VN[w] = 0; }
    uint64_t mask = 1ULL << ((m - 1) & 63);
    int64_t dist = (int64_t)m;
    for (size_t j = 0; j < n; j++) {
        const uint64_t* pmv =
            (uint64_t)b[j] < 256 ? pm + (uint64_t)b[j] * W : nullptr;
        uint64_t hp_c = 1, hn_c = 0;           // top boundary: D[0][j] = j
        for (size_t w = 0; w < W; w++) {
            uint64_t x = (pmv ? pmv[w] : 0) | hn_c;
            uint64_t vp = VP[w], vn = VN[w];
            uint64_t d0 = (((x & vp) + vp) ^ vp) | x | vn;
            uint64_t hp = vn | ~(d0 | vp);
            uint64_t hn = d0 & vp;
            if (w == W - 1)
                dist += (int64_t)((hp & mask) != 0)
                      - (int64_t)((hn & mask) != 0);
            uint64_t hp_s = (hp << 1) | hp_c;
            uint64_t hn_s = (hn << 1) | hn_c;
            hp_c = hp >> 63;
            hn_c = hn >> 63;
            VP[w] = hn_s | ~(d0 | hp_s);
            VN[w] = hp_s & d0;
        }
    }
    return dist;
}

template <size_t W>
static int64_t lcs_w(const int64_t* a, size_t m,
                     const int64_t* b, size_t n) {
    uint64_t pm[256 * W];
    memset(pm, 0, sizeof(pm));
    for (size_t i = 0; i < m; i++)
        pm[(size_t)a[i] * W + (i >> 6)] |= 1ULL << (i & 63);
    uint64_t S[W];
    for (size_t w = 0; w < W; w++) S[w] = ~0ULL;
    for (size_t j = 0; j < n; j++) {
        const uint64_t* pmv =
            (uint64_t)b[j] < 256 ? pm + (uint64_t)b[j] * W : nullptr;
        uint64_t carry = 0;
        for (size_t w = 0; w < W; w++) {
            uint64_t s = S[w];
            uint64_t u = s & (pmv ? pmv[w] : 0);
            uint64_t t = s + u;
            uint64_t c1 = t < s;
            uint64_t t2 = t + carry;
            uint64_t c2 = t2 < t;
            carry = c1 | c2;
            S[w] = t2 | (s - u);               // padding bits stay 1
        }
    }
    int64_t lcs = 0;
    for (size_t w = 0; w < W; w++)
        lcs += __builtin_popcountll(~S[w]);
    return lcs;
}

template <size_t W>
static int64_t osa_w(const int64_t* a, size_t m,
                     const int64_t* b, size_t n) {
    uint64_t pm[256 * W];
    memset(pm, 0, sizeof(pm));
    for (size_t i = 0; i < m; i++)
        pm[(size_t)a[i] * W + (i >> 6)] |= 1ULL << (i & 63);
    uint64_t VP[W], VN[W], D0P[W], PMP[W];
    for (size_t w = 0; w < W; w++) {
        VP[w] = ~0ULL; VN[w] = 0; D0P[w] = 0; PMP[w] = 0;
    }
    uint64_t mask = 1ULL << ((m - 1) & 63);
    int64_t dist = (int64_t)m;
    for (size_t j = 0; j < n; j++) {
        const uint64_t* pmv =
            (uint64_t)b[j] < 256 ? pm + (uint64_t)b[j] * W : nullptr;
        uint64_t hp_c = 1, hn_c = 0, tr_c = 0;
        for (size_t w = 0; w < W; w++) {
            uint64_t pmw = pmv ? pmv[w] : 0;
            uint64_t d0p = D0P[w];
            uint64_t tr = (((~d0p & pmw) << 1) | tr_c) & PMP[w];
            tr_c = (~d0p & pmw) >> 63;
            uint64_t x = pmw | hn_c;
            uint64_t vp = VP[w], vn = VN[w];
            uint64_t d0 = ((((x & vp) + vp) ^ vp) | x | vn) | tr;
            uint64_t hp = vn | ~(d0 | vp);
            uint64_t hn = d0 & vp;
            if (w == W - 1)
                dist += (int64_t)((hp & mask) != 0)
                      - (int64_t)((hn & mask) != 0);
            uint64_t hp_s = (hp << 1) | hp_c;
            uint64_t hn_s = (hn << 1) | hn_c;
            hp_c = hp >> 63;
            hn_c = hn >> 63;
            VP[w] = hn_s | ~(d0 | hp_s);
            VN[w] = hp_s & d0;
            D0P[w] = d0;
            PMP[w] = pmw;
        }
    }
    return dist;
}

// W = ceil(m/64) in [2, 8] dispatchers; INT64_MIN = caller falls through.
// W == 2 rides the native-__int128 kernels above.
#define SMALLW_DISPATCH(fn)                                            \
    switch ((m + 63) >> 6) {                                           \
        case 2: return fn##_128(a, m, b, n);                           \
        case 3: return fn<3>(a, m, b, n);                              \
        case 4: return fn<4>(a, m, b, n);                              \
        case 5: return fn<5>(a, m, b, n);                              \
        case 6: return fn<6>(a, m, b, n);                              \
        case 7: return fn<7>(a, m, b, n);                              \
        case 8: return fn<8>(a, m, b, n);                              \
        default: return INT64_MIN;                                     \
    }

static int64_t lev_smallw(const int64_t* a, size_t m,
                          const int64_t* b, size_t n) {
    SMALLW_DISPATCH(lev_w)
}

static int64_t lcs_smallw(const int64_t* a, size_t m,
                          const int64_t* b, size_t n) {
    SMALLW_DISPATCH(lcs_w)
}

static int64_t osa_smallw(const int64_t* a, size_t m,
                          const int64_t* b, size_t n) {
    SMALLW_DISPATCH(osa_w)
}

// Bit-parallel Jaro flagging (flag_similar_characters_word generalized to
// W pattern words, jaro.rs:147-190): per text char, candidates =
// PM[c] & window & ~flagged, claim the lowest set bit (blsi semantics).
// The text side needs no bitmask — matched text chars are collected in
// scan order for the rank-wise transposition count (jaro.rs:339-368).
template <size_t W>
static size_t jaro_flag_w(const int64_t* pa, size_t m, const int64_t* pb,
                          size_t t, size_t bound, int64_t* fb,
                          uint64_t* pflag_out) {
    uint64_t pm[256 * W];
    memset(pm, 0, sizeof(pm));
    for (size_t i = 0; i < m; i++)
        pm[(size_t)pa[i] * W + (i >> 6)] |= 1ULL << (i & 63);
    uint64_t pflag[W];
    for (size_t w = 0; w < W; w++) pflag[w] = 0;
    size_t nf = 0;
    for (size_t j = 0; j < t; j++) {
        size_t lo = (j > bound) ? j - bound : 0;
        if (lo >= m) break;                    // window left the pattern
        size_t hi = j + bound + 1;
        if (hi > m) hi = m;
        uint64_t c = (uint64_t)pb[j];
        if (c >= 256) continue;                // cannot match a small char
        const uint64_t* pmv = pm + c * W;
        size_t w0 = lo >> 6, w1 = (hi - 1) >> 6;
        for (size_t w = w0; w <= w1; w++) {
            size_t base = w << 6;
            size_t l = lo > base ? lo - base : 0;
            size_t h = hi - base > 64 ? 64 : hi - base;
            uint64_t mask = (h == 64 ? ~0ULL : ((1ULL << h) - 1))
                          & ~(l == 0 ? 0ULL : ((1ULL << l) - 1));
            uint64_t cand = pmv[w] & mask & ~pflag[w];
            if (cand) {
                pflag[w] |= cand & (~cand + 1);    // lowest set bit
                fb[nf++] = pb[j];
                break;
            }
        }
    }
    for (size_t w = 0; w < W; w++) pflag_out[w] = pflag[w];
    return nf;
}

static size_t jaro_flag_smallw(const int64_t* a, size_t m,
                               const int64_t* b, size_t t, size_t bound,
                               int64_t* fb, uint64_t* pflag_out) {
    switch ((m + 63) >> 6) {
        case 1: return jaro_flag_w<1>(a, m, b, t, bound, fb, pflag_out);
        case 2: return jaro_flag_w<2>(a, m, b, t, bound, fb, pflag_out);
        case 3: return jaro_flag_w<3>(a, m, b, t, bound, fb, pflag_out);
        case 4: return jaro_flag_w<4>(a, m, b, t, bound, fb, pflag_out);
        case 5: return jaro_flag_w<5>(a, m, b, t, bound, fb, pflag_out);
        case 6: return jaro_flag_w<6>(a, m, b, t, bound, fb, pflag_out);
        case 7: return jaro_flag_w<7>(a, m, b, t, bound, fb, pflag_out);
        default: return jaro_flag_w<8>(a, m, b, t, bound, fb, pflag_out);
    }
}

// Reusable per-thread buffers: the one-shot scalar path calls these
// kernels at microsecond granularity, where per-call vector mallocs are
// a large fraction of the total (measured ~2x on len<=128 pairs).
struct BpScratch {
    SymMap sm;
    vector<uint64_t> pool, d256;
    vector<uint64_t> VP, VN, D0P, PMP, S;
    vector<uint8_t> hin, trin, cin;
};

static BpScratch& bp_scratch() {
    static thread_local BpScratch s;
    return s;
}

// hin/hout encoding in the boundary stream: 0 -> -1, 1 -> 0, 2 -> +1.

// Full Myers blockwise uniform Levenshtein, row-chunked.  The distance is
// tracked at the REAL last pattern row: pre-shift HP/HN bit (m-1) % 64 of
// word (m-1) / 64 (matching ops/levenshtein.py's test_bit(last_pos) —
// padded sentinel rows above m can be absorbed by substitutions, so the
// top word bit is NOT an offset of D[m][j]).
static int64_t lev_bp_full(const int64_t* a, size_t m,
                           const int64_t* b, size_t n) {
    size_t W = (m + 63) >> 6;
    size_t bit = (m - 1) & 63;                 // score bit in word W-1
    size_t nch = (W + CHUNK_WORDS - 1) / CHUNK_WORDS;
    BpScratch& bs = bp_scratch();
    vector<uint8_t>& hin = bs.hin;
    hin.assign(n, 2);                          // top boundary: D[0][j] = j
    vector<uint64_t>& VP = bs.VP;
    vector<uint64_t>& VN = bs.VN;
    VP.resize(CHUNK_WORDS);
    VN.resize(CHUNK_WORDS);
    SymMap& sm = bs.sm;
    vector<uint64_t>& pool = bs.pool;
    int64_t dist = (int64_t)m;
    for (size_t c = 0; c < nch; c++) {
        size_t w0 = c * CHUNK_WORDS, w1 = min(W, w0 + CHUNK_WORDS);
        size_t ww = w1 - w0;
        bool direct = build_pm_chunk(a, w0 * 64, min(m, w1 * 64), ww, sm,
                                     pool, bs.d256);
        for (size_t w = 0; w < ww; w++) { VP[w] = ~0ULL; VN[w] = 0; }
        bool lastc = (c == nch - 1);
        for (size_t j = 0; j < n; j++) {
            const uint64_t* pmv = pm_find(direct, sm, pool, bs.d256, ww,
                                          b[j]);
            uint64_t hp_c = hin[j] == 2, hn_c = hin[j] == 0;
            for (size_t w = 0; w < ww; w++) {
                uint64_t x = (pmv ? pmv[w] : 0) | hn_c;
                uint64_t vp = VP[w], vn = VN[w];
                uint64_t d0 = (((x & vp) + vp) ^ vp) | x | vn;
                uint64_t hp = vn | ~(d0 | vp);
                uint64_t hn = d0 & vp;
                if (lastc && w == ww - 1)
                    dist += (int64_t)((hp >> bit) & 1)
                          - (int64_t)((hn >> bit) & 1);
                uint64_t hp_s = (hp << 1) | hp_c;
                uint64_t hn_s = (hn << 1) | hn_c;
                hp_c = hp >> 63;
                hn_c = hn >> 63;
                VP[w] = hn_s | ~(d0 | hp_s);
                VN[w] = hp_s & d0;
            }
            hin[j] = hp_c ? 2 : (hn_c ? 0 : 1);
        }
    }
    return dist;
}

// Banded Myers blockwise: exact if the distance <= k, else returns k + 1.
// Static Ukkonen band in word-block units; blocks enter at the bottom with
// their column-0 state (VP=~0, VN=0, bottom value i) — a stand-in that is
// >= the true cell value and > k at entry, so in-band cells compute exactly
// when the true distance <= k (see dropped-block proof in tests).  Frozen
// top blocks feed hin=+1 (their bottom row's stand-in grows +1 per column,
// still an overestimate).  Returns INT64_MIN if the dense PM table would
// exceed the memory cap (caller falls back).
static int64_t lev_bp_banded(const int64_t* a, size_t m,
                             const int64_t* b, size_t n, int64_t k) {
    size_t W = (m + 63) >> 6;
    size_t bit = (m - 1) & 63;                 // score bit in word W-1
    // dense PM over the whole pattern: sigma * W words, capped at 128 MiB
    {
        SymMap probe;
        probe.init(m);
        const size_t cap_words = (size_t)1 << 24;      // 128 MiB of masks
        for (size_t i = 0; i < m; i++) {
            probe.insert(a[i]);
            if (probe.n * W > cap_words) return INT64_MIN;
        }
    }
    BpScratch& bs = bp_scratch();
    SymMap& sm = bs.sm;
    vector<uint64_t>& pool = bs.pool;
    bool direct = build_pm_chunk(a, 0, m, W, sm, pool, bs.d256);
    // score[w] = value at block w's bottom row (row (w+1)*64, or m for the
    // last block).  The bit state carries deltas only, so an entering
    // block's stand-in is anchored at the computed boundary row above it:
    // entry value = score[w-1] + rows-below-boundary (still >= the true
    // cell values: going down |rows| deletions from the boundary).
    vector<uint64_t> VP(W), VN(W);
    vector<int64_t> score(W);
    auto bottom_row = [&](size_t w) -> int64_t {
        return w == W - 1 ? (int64_t)m : (int64_t)((w + 1) * 64);
    };
    size_t last = (size_t)min<int64_t>((int64_t)W - 1, k / 64);
    size_t first = 0;
    for (size_t w = 0; w <= last; w++) {
        VP[w] = ~0ULL;
        VN[w] = 0;
        score[w] = bottom_row(w);              // column-0 state: D[i][0] = i
    }
    for (size_t j = 1; j <= n; j++) {
        int64_t maxrow = min<int64_t>((int64_t)m, (int64_t)j + k);
        size_t last_needed = (size_t)((maxrow - 1) >> 6);
        while (last < last_needed) {
            ++last;
            VP[last] = ~0ULL;
            VN[last] = 0;
            score[last] = score[last - 1] + bottom_row(last)
                        - bottom_row(last - 1);
        }
        int64_t minrow = (int64_t)j - k;
        if (minrow > (int64_t)m) return k + 1;     // band left the matrix
        if (minrow > 1) first = max(first, (size_t)((minrow - 1) >> 6));
        const uint64_t* pmv = pm_find(direct, sm, pool, bs.d256, W,
                                      b[j - 1]);
        uint64_t hp_c = 1, hn_c = 0;           // top boundary / frozen rule
        for (size_t w = first; w <= last; w++) {
            uint64_t x = (pmv ? pmv[w] : 0) | hn_c;
            uint64_t vp = VP[w], vn = VN[w];
            uint64_t d0 = (((x & vp) + vp) ^ vp) | x | vn;
            uint64_t hp = vn | ~(d0 | vp);
            uint64_t hn = d0 & vp;
            size_t wbit = (w == W - 1) ? bit : 63;
            score[w] += (int64_t)((hp >> wbit) & 1)
                      - (int64_t)((hn >> wbit) & 1);
            uint64_t hp_s = (hp << 1) | hp_c;
            uint64_t hn_s = (hn << 1) | hn_c;
            hp_c = hp >> 63;
            hn_c = hn >> 63;
            VP[w] = hn_s | ~(d0 | hp_s);
            VN[w] = hp_s & d0;
        }
    }
    if (last != W - 1) return k + 1;
    return score[W - 1] <= k ? score[W - 1] : k + 1;
}

}  // namespace

static int jaro_try_bitflag(const int64_t* pa, size_t m, const int64_t* pb,
                            size_t t, size_t bound, size_t* common_add,
                            size_t* transpositions) {
    if (m == 0 || m > 512 || !all_small(pa, m)) return 0;
    int64_t fbbuf[512];                        // nf <= m <= 512
    uint64_t pflag[8] = {0};
    size_t nf = jaro_flag_smallw(pa, m, pb, t, bound, fbbuf, pflag);
    *common_add = nf;
    size_t W = (m + 63) >> 6, k = 0, tr = 0;
    for (size_t w = 0; w < W; w++) {
        uint64_t f = pflag[w];
        while (f) {
            size_t i = (w << 6) + (size_t)__builtin_ctzll(f);
            f &= f - 1;
            tr += (pa[i] != fbbuf[k++]);
        }
    }
    *transpositions = tr;
    return 1;
}

extern "C" {

// Uniform Levenshtein, bit-parallel: exact if the distance <= cutoff, else
// any value > cutoff (cutoff + 1).  cutoff < 0 means no cutoff (full exact).
int64_t rf_levenshtein_uniform_bp(const int64_t* a, int64_t n1_,
                                  const int64_t* b, int64_t n2_,
                                  int64_t cutoff) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    strip_affix(a, n1, b, n2);
    if (n1 == 0) return (int64_t)n2;
    if (n2 == 0) return (int64_t)n1;
    int64_t ldiff = n1 > n2 ? (int64_t)(n1 - n2) : (int64_t)(n2 - n1);
    if (cutoff >= 0 && ldiff > cutoff) return cutoff + 1;
    if (n1 > n2) { std::swap(a, b); std::swap(n1, n2); }     // symmetric
    // affixes are stripped, so equal strings are both empty by now
    if (cutoff == 0) return (n1 | n2) ? 1 : 0;
    if (cutoff > 0 && cutoff < 4)
        return lev_mbleven(b, n2, a, n1, cutoff);
    if (n1 <= 64 && all_small(a, n1)) {
        int64_t d = lev_1w(a, n1, b, n2);
        return (cutoff >= 0 && d > cutoff) ? cutoff + 1 : d;
    }
    // banded pays off when the band is well under the pattern height
    if (cutoff >= 0 && (size_t)cutoff + 128 < n1) {
        int64_t r = lev_bp_banded(a, n1, b, n2, cutoff);
        if (r != INT64_MIN) return r;
        return lev_banded(a, n1, b, n2, cutoff);   // PM cap hit: O(k*M) DP
    }
    if (n1 <= 512 && all_small(a, n1)) {
        int64_t d = lev_smallw(a, n1, b, n2);
        if (d != INT64_MIN)
            return (cutoff >= 0 && d > cutoff) ? cutoff + 1 : d;
    }
    int64_t d = lev_bp_full(a, n1, b, n2);
    return (cutoff >= 0 && d > cutoff) ? cutoff + 1 : d;
}

// Hyyro bit-parallel LCS length (lcs_seq.rs:199-261 semantics; mirrors
// ops/lcs.py): per column, per word: u = s & pm; s = (s + u + carry) |
// (s - u), add carry chained upward.  LCS = count of zero bits (padding
// bits stay 1: u is a subset of s so s - u = s & ~u never borrows).
int64_t rf_lcs_seq_bp(const int64_t* a, int64_t n1_,
                      const int64_t* b, int64_t n2_) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    size_t suf = common_suffix(a, n1, b, n2);
    n1 -= suf; n2 -= suf;
    size_t pre = common_prefix(a, n1, b, n2);
    a += pre; b += pre; n1 -= pre; n2 -= pre;
    int64_t affix = (int64_t)(pre + suf);
    if (n1 == 0 || n2 == 0) return affix;
    if (n1 > n2) { std::swap(a, b); std::swap(n1, n2); }     // symmetric
    if (all_small(a, n1)) {
        if (n1 <= 64) return affix + lcs_1w(a, n1, b, n2);
        if (n1 <= 512) {
            int64_t l = lcs_smallw(a, n1, b, n2);
            if (l != INT64_MIN) return affix + l;
        }
    }
    size_t m = n1, n = n2;
    size_t W = (m + 63) >> 6;
    size_t nch = (W + CHUNK_WORDS - 1) / CHUNK_WORDS;
    BpScratch& bs = bp_scratch();
    vector<uint8_t>& cin = bs.cin;
    cin.assign(n, 0);
    vector<uint64_t>& S = bs.S;
    S.resize(CHUNK_WORDS);
    SymMap& sm = bs.sm;
    vector<uint64_t>& pool = bs.pool;
    int64_t lcs = 0;
    for (size_t c = 0; c < nch; c++) {
        size_t w0 = c * CHUNK_WORDS, w1 = min(W, w0 + CHUNK_WORDS);
        size_t ww = w1 - w0;
        bool direct = build_pm_chunk(a, w0 * 64, min(m, w1 * 64), ww, sm,
                                     pool, bs.d256);
        for (size_t w = 0; w < ww; w++) S[w] = ~0ULL;
        for (size_t j = 0; j < n; j++) {
            const uint64_t* pmv = pm_find(direct, sm, pool, bs.d256, ww,
                                          b[j]);
            uint64_t carry = cin[j];
            for (size_t w = 0; w < ww; w++) {
                uint64_t s = S[w];
                uint64_t u = s & (pmv ? pmv[w] : 0);
                uint64_t t = s + u;
                uint64_t c1 = t < s;
                uint64_t t2 = t + carry;
                uint64_t c2 = t2 < t;
                carry = c1 | c2;
                S[w] = t2 | (s - u);
            }
            cin[j] = (uint8_t)carry;
        }
        for (size_t w = 0; w < ww; w++)
            lcs += __builtin_popcountll(~S[w]);
    }
    return affix + lcs;
}

int64_t rf_indel_bp(const int64_t* a, int64_t n1, const int64_t* b,
                    int64_t n2) {
    return n1 + n2 - 2 * rf_lcs_seq_bp(a, n1, b, n2);
}

// Hyyro bit-parallel OSA (osa.rs:84-227 semantics; mirrors ops/osa.py):
// Myers step plus the transposition mask
//   tr = (((~d0_prev & pm) << 1) | cross-word carry) & pm_prev
// folded into D0; d0/pm of the previous column kept per word.  Row-chunked
// with hp/hn + transposition-carry boundary streams.
int64_t rf_osa_bp(const int64_t* a, int64_t n1_,
                  const int64_t* b, int64_t n2_) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    strip_affix(a, n1, b, n2);
    if (n1 == 0) return (int64_t)n2;
    if (n2 == 0) return (int64_t)n1;
    if (n1 > n2) { std::swap(a, b); std::swap(n1, n2); }     // symmetric
    if (all_small(a, n1)) {
        if (n1 <= 64) return osa_1w(a, n1, b, n2);
        if (n1 <= 512) {
            int64_t d = osa_smallw(a, n1, b, n2);
            if (d != INT64_MIN) return d;
        }
    }
    size_t m = n1, n = n2;
    size_t W = (m + 63) >> 6;
    size_t bit = (m - 1) & 63;                 // score bit in word W-1
    size_t nch = (W + CHUNK_WORDS - 1) / CHUNK_WORDS;
    BpScratch& bs = bp_scratch();
    vector<uint8_t>& hin = bs.hin;
    vector<uint8_t>& trin = bs.trin;
    hin.assign(n, 2);
    trin.assign(n, 0);
    vector<uint64_t>& VP = bs.VP;
    vector<uint64_t>& VN = bs.VN;
    vector<uint64_t>& D0P = bs.D0P;
    vector<uint64_t>& PMP = bs.PMP;
    VP.resize(CHUNK_WORDS);
    VN.resize(CHUNK_WORDS);
    D0P.resize(CHUNK_WORDS);
    PMP.resize(CHUNK_WORDS);
    SymMap& sm = bs.sm;
    vector<uint64_t>& pool = bs.pool;
    int64_t dist = (int64_t)m;
    for (size_t c = 0; c < nch; c++) {
        size_t w0 = c * CHUNK_WORDS, w1 = min(W, w0 + CHUNK_WORDS);
        size_t ww = w1 - w0;
        bool direct = build_pm_chunk(a, w0 * 64, min(m, w1 * 64), ww, sm,
                                     pool, bs.d256);
        for (size_t w = 0; w < ww; w++) {
            VP[w] = ~0ULL; VN[w] = 0; D0P[w] = 0; PMP[w] = 0;
        }
        bool lastc = (c == nch - 1);
        for (size_t j = 0; j < n; j++) {
            const uint64_t* pmv = pm_find(direct, sm, pool, bs.d256, ww,
                                          b[j]);
            uint64_t hp_c = hin[j] == 2, hn_c = hin[j] == 0;
            uint64_t tr_c = trin[j];           // (~d0_prev & pm)>>63, word below
            for (size_t w = 0; w < ww; w++) {
                uint64_t pmw = pmv ? pmv[w] : 0;
                uint64_t d0p = D0P[w];
                uint64_t tr = (((~d0p & pmw) << 1) | tr_c) & PMP[w];
                tr_c = (~d0p & pmw) >> 63;
                uint64_t x = pmw | hn_c;
                uint64_t vp = VP[w], vn = VN[w];
                uint64_t d0 = ((((x & vp) + vp) ^ vp) | x | vn) | tr;
                uint64_t hp = vn | ~(d0 | vp);
                uint64_t hn = d0 & vp;
                if (lastc && w == ww - 1)
                    dist += (int64_t)((hp >> bit) & 1)
                          - (int64_t)((hn >> bit) & 1);
                uint64_t hp_s = (hp << 1) | hp_c;
                uint64_t hn_s = (hn << 1) | hn_c;
                hp_c = hp >> 63;
                hn_c = hn >> 63;
                VP[w] = hn_s | ~(d0 | hp_s);
                VN[w] = hp_s & d0;
                D0P[w] = d0;
                PMP[w] = pmw;
            }
            hin[j] = hp_c ? 2 : (hn_c ? 0 : 1);
            trin[j] = (uint8_t)tr_c;
        }
    }
    return dist;
}

// ---- uint8 fast lane: raw str(PEP 393 kind-1)/bytes front door for the
// one-shot scalar extension (native/rf_scalar.cpp).  Same semantics as
// the int64 entries above, instantiated on uint8 elements: zero
// conversion, and every `< 256` table check folds away.  Covers the
// criterion bench class (pattern <= 128 after affix strip, any text
// length); returns INT64_MIN when the inputs fall outside it — the
// caller converts to int64 and takes the general path.

int64_t rf_levenshtein_uniform_bp_u8(const uint8_t* a, int64_t n1_,
                                     const uint8_t* b, int64_t n2_,
                                     int64_t cutoff) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    strip_affix(a, n1, b, n2);
    if (n1 == 0) return (int64_t)n2;
    if (n2 == 0) return (int64_t)n1;
    int64_t ldiff = n1 > n2 ? (int64_t)(n1 - n2) : (int64_t)(n2 - n1);
    if (cutoff >= 0 && ldiff > cutoff) return cutoff + 1;
    if (n1 > n2) { std::swap(a, b); std::swap(n1, n2); }     // symmetric
    if (cutoff == 0) return 1;             // affixes stripped -> not equal
    if (cutoff > 0 && cutoff < 4)
        return lev_mbleven(b, n2, a, n1, cutoff);
    int64_t d;
    if (n1 <= 64) d = lev_1w(a, n1, b, n2);
    else if (n1 <= 128) d = lev_w_128(a, n1, b, n2);
    else return INT64_MIN;
    return (cutoff >= 0 && d > cutoff) ? cutoff + 1 : d;
}

int64_t rf_lcs_seq_bp_u8(const uint8_t* a, int64_t n1_,
                         const uint8_t* b, int64_t n2_) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    size_t suf = common_suffix(a, n1, b, n2);
    n1 -= suf; n2 -= suf;
    size_t pre = common_prefix(a, n1, b, n2);
    a += pre; b += pre; n1 -= pre; n2 -= pre;
    int64_t affix = (int64_t)(pre + suf);    // affixes count toward LCS
    if (n1 == 0 || n2 == 0) return affix;
    if (n1 > n2) { std::swap(a, b); std::swap(n1, n2); }     // symmetric
    if (n1 <= 64) return affix + lcs_1w(a, n1, b, n2);
    if (n1 <= 128) return affix + lcs_w_128(a, n1, b, n2);
    return INT64_MIN;
}

int64_t rf_indel_bp_u8(const uint8_t* a, int64_t n1,
                       const uint8_t* b, int64_t n2) {
    int64_t l = rf_lcs_seq_bp_u8(a, n1, b, n2);
    return l == INT64_MIN ? INT64_MIN : n1 + n2 - 2 * l;
}

// Indel distance under a tiny miss budget (0 <= kmiss <= 4): exact if
// the distance <= kmiss, else any value > kmiss.  The reference's
// max_misses < 5 ladder position (lcs_seq.rs:488-532) — no PM table,
// no word loop, just affix strip + an op-script walk.
int64_t rf_indel_bp_u8_cut(const uint8_t* a, int64_t n1_,
                           const uint8_t* b, int64_t n2_, int64_t kmiss) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    size_t suf = common_suffix(a, n1, b, n2);
    n1 -= suf; n2 -= suf;
    size_t pre = common_prefix(a, n1, b, n2);
    a += pre; b += pre; n1 -= pre; n2 -= pre;
    if (n1 == 0 || n2 == 0) return (int64_t)(n1 + n2);       // exact
    if (n1 < n2) { std::swap(a, b); std::swap(n1, n2); }     // a longer
    int64_t diff = (int64_t)(n1 - n2);
    if (diff > kmiss) return kmiss + 1;
    if (kmiss <= 0) return 1;        // not equal after strip: distance
                                     // >= 1 > 0 == kmiss
    if (kmiss <= 4) return indel_mbleven(a, n1, b, n2, kmiss);
    int64_t l = rf_lcs_seq_bp_u8(a, (int64_t)n1, b, (int64_t)n2);
    return l == INT64_MIN ? INT64_MIN : (int64_t)(n1 + n2) - 2 * l;
}

int64_t rf_indel_bp_cut(const int64_t* a, int64_t n1_,
                        const int64_t* b, int64_t n2_, int64_t kmiss) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    size_t suf = common_suffix(a, n1, b, n2);
    n1 -= suf; n2 -= suf;
    size_t pre = common_prefix(a, n1, b, n2);
    a += pre; b += pre; n1 -= pre; n2 -= pre;
    if (n1 == 0 || n2 == 0) return (int64_t)(n1 + n2);
    if (n1 < n2) { std::swap(a, b); std::swap(n1, n2); }
    int64_t diff = (int64_t)(n1 - n2);
    if (diff > kmiss) return kmiss + 1;
    if (kmiss <= 0) return 1;
    if (kmiss <= 4) return indel_mbleven(a, n1, b, n2, kmiss);
    return rf_indel_bp(a, (int64_t)n1, b, (int64_t)n2);
}

int64_t rf_osa_bp_u8(const uint8_t* a, int64_t n1_,
                     const uint8_t* b, int64_t n2_) {
    size_t n1 = (size_t)n1_, n2 = (size_t)n2_;
    strip_affix(a, n1, b, n2);
    if (n1 == 0) return (int64_t)n2;
    if (n2 == 0) return (int64_t)n1;
    if (n1 > n2) { std::swap(a, b); std::swap(n1, n2); }     // symmetric
    if (n1 <= 64) return osa_1w(a, n1, b, n2);
    if (n1 <= 128) return osa_w_128(a, n1, b, n2);
    return INT64_MIN;
}

int64_t rf_hamming_u8(const uint8_t* a, int64_t n1,
                      const uint8_t* b, int64_t n2) {
    int64_t n = n1 < n2 ? n1 : n2;
    int64_t d = n1 > n2 ? n1 - n2 : n2 - n1;
    for (int64_t i = 0; i < n; i++) d += a[i] != b[i];
    return d;
}

int64_t rf_prefix_sim_u8(const uint8_t* a, int64_t n1,
                         const uint8_t* b, int64_t n2) {
    return (int64_t)common_prefix(a, (size_t)n1, b, (size_t)n2);
}

int64_t rf_postfix_sim_u8(const uint8_t* a, int64_t n1,
                          const uint8_t* b, int64_t n2) {
    return (int64_t)common_suffix(a, (size_t)n1, b, (size_t)n2);
}

}  // extern "C"
