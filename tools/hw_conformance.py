"""Deep device-vs-oracle conformance sweep.

The unit suite runs the scan kernel in Pallas' interpreter on the CPU; it
cannot see what the GPU compiler makes of it.  This sweep goes deeper on
the card: per metric it scans mixed-class corpora (ASCII, small-alphabet
transposition-rich, wide Unicode, query-derived mutants, length
boundaries 0/1/31..129, long multi-word buckets) with several queries
(incl. empty / 1-char / Unicode-vs-ASCII misses) and cutoff/hint
variants, and verifies EVERY corpus entry against the C++ oracle
(`native/oracle.cpp`), including the `(values, valid)` mask contract under
cutoffs (`common.rs:33-46` Option semantics).  The metrics the scan kernel
serves run twice: once with the wide-Unicode class (XLA route) and once
without it (the kernel's byte route on a GPU).

`chip_smoke.py` runs these checks on the card; alone:
    python tools/hw_conformance.py [--checks a,b]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _enc(s):
    return np.array([ord(c) for c in s], np.int64)


def _mixed_corpus(rng, n_ascii=512, n_small=256, n_uni=128, n_bound=72,
                  n_long=64, maxlen=96, longmax=384, query=""):
    """Corpus classes exercising every routing dimension."""
    out = []
    for _ in range(n_ascii):
        L = int(rng.integers(0, maxlen + 1))
        out.append("".join(chr(97 + int(c))
                           for c in rng.integers(0, 26, L)))
    for _ in range(n_small):                      # transposition-rich
        L = int(rng.integers(2, min(64, maxlen) + 1))
        out.append("".join(chr(97 + int(c)) for c in rng.integers(0, 5, L)))
    for _ in range(n_uni):                        # wide alphabet (remap)
        L = int(rng.integers(1, min(48, maxlen) + 1))
        cps = rng.choice([0x100, 0x3B1, 0x430, 0x4E00, 0x1F600], L)
        out.append("".join(chr(int(c) + int(o))
                           for c, o in zip(cps, rng.integers(0, 40, L))))
    for L in (0, 1, 2, 31, 32, 33, 63, 64, 65, 95, 96, 97):  # boundaries
        for _ in range(n_bound // 12):
            out.append("".join(chr(97 + int(c))
                               for c in rng.integers(0, 26, L)))
    for _ in range(n_long):                       # multi-word buckets
        L = int(rng.integers(maxlen + 1, longmax + 1))
        out.append("".join(chr(97 + int(c))
                           for c in rng.integers(0, 26, L)))
    if query:                                     # query-derived mutants
        out.append(query)
        out.append(query[: len(query) // 2])
        out.append(query[len(query) // 2:])
        for _ in range(16):
            s = list(query)
            for _ in range(int(rng.integers(1, 4))):
                op = int(rng.integers(0, 3))
                i = int(rng.integers(0, max(1, len(s))))
                if op == 0 and s:
                    s[i % len(s)] = chr(97 + int(rng.integers(0, 26)))
                elif op == 1 and len(s) >= 2:
                    j = i % (len(s) - 1)
                    s[j], s[j + 1] = s[j + 1], s[j]
                elif s:
                    del s[i % len(s)]
            out.append("".join(s))
    return out


def _queries(rng, maxlen=64):
    qs = ["", "a",
          "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 7)),
          "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 33)),
          "".join(chr(97 + int(c)) for c in rng.integers(0, 26, maxlen)),
          "".join(chr(0x430 + int(c)) for c in rng.integers(0, 30, 12))]
    return qs


def _verify(metric, sc, corpus, oracle_fn, cases, f64=False):
    """Scan with each (cutoff, hint) case; verify the FULL corpus."""
    n = 0
    t_first = None
    for cutoff, hint, q in cases:
        kw = {}
        if cutoff is not None:
            kw["score_cutoff"] = cutoff
        if hint is not None:
            kw["score_hint"] = hint
        t0 = time.perf_counter()
        d = sc.distances(q, **kw)
        if t_first is None:
            t_first = time.perf_counter() - t0
        if cutoff is not None:
            values, valid = np.asarray(d.values), np.asarray(d.valid)
        else:
            values, valid = np.asarray(d), None
        qe = _enc(q)
        for i, s in enumerate(corpus):
            exp = oracle_fn(qe, _enc(s))
            n += 1
            if cutoff is not None:
                if f64 and abs(exp - cutoff) < 1e-9:
                    continue    # ULP-boundary: mask side is don't-care
                ok = exp <= cutoff
                assert bool(valid[i]) == bool(ok), \
                    (metric, q[:16], i, exp, cutoff, bool(valid[i]))
                if not ok:
                    continue
            got = values[i]
            if f64:
                assert abs(float(got) - exp) < 1e-9, \
                    (metric, q[:16], i, float(got), exp)
            else:
                assert int(got) == int(exp), \
                    (metric, q[:16], i, int(got), int(exp))
    return n, t_first


def _check_int_metric(metric, oracle_fn, seed, cutoffs=(2, 15, 47),
                      weights=None, maxlen=96, longmax=384):
    from rapidfuzz_tpu.ops.route import KERNEL_METRICS
    from rapidfuzz_tpu.parallel.scan import CorpusScanner

    n, t_first = 0, None
    # with the wide class the corpus takes the XLA route; without it the
    # kernel metrics take the scan kernel on a GPU
    for n_uni in ((128, 0) if metric in KERNEL_METRICS and weights is None
                  else (128,)):
        rng = np.random.default_rng(seed)
        qs = _queries(rng)
        corpus = _mixed_corpus(rng, n_uni=n_uni, maxlen=maxlen,
                               longmax=longmax, query=qs[4])
        sc = CorpusScanner(corpus, metric=metric, weights=weights)
        cases = [(None, None, q) for q in qs]
        for c in cutoffs:
            cases.append((c, None, qs[4]))
            cases.append((c, None, qs[2]))
        if metric == "levenshtein" and weights is None:
            cases += [(None, 1, qs[4]), (None, 64, qs[4]), (15, 4, qs[4])]
        k, t = _verify(metric, sc, corpus, oracle_fn, cases)
        n += k
        t_first = t if t_first is None else t_first
    return n, t_first


def _c_levenshtein():
    from rapidfuzz_tpu import oracle
    return _check_int_metric("levenshtein", oracle.levenshtein_uniform, 21)


def _c_wlev():
    from rapidfuzz_tpu import oracle
    return _check_int_metric(
        "levenshtein",
        lambda a, b: oracle.levenshtein_weighted(a, b, 1, 2, 3),
        22, cutoffs=(5, 31), weights=(1, 2, 3))


def _c_indel():
    from rapidfuzz_tpu import oracle
    return _check_int_metric("indel", oracle.indel, 23)


def _c_lcs():
    from rapidfuzz_tpu import oracle
    return _check_int_metric(
        "lcs_seq",
        lambda a, b: max(a.size, b.size) - oracle.lcs_seq(a, b), 24)


def _c_osa():
    from rapidfuzz_tpu import oracle
    return _check_int_metric("osa", oracle.osa, 25)


def _c_damerau():
    from rapidfuzz_tpu import oracle
    # long buckets bounded (oracle is O(N*M) per pair over 6 queries)
    return _check_int_metric("damerau_levenshtein", oracle.damerau, 26,
                             cutoffs=(2, 15), maxlen=96, longmax=256)


def _c_prefix():
    from rapidfuzz_tpu import oracle
    return _check_int_metric(
        "prefix",
        lambda a, b: max(a.size, b.size) - oracle.prefix_sim(a, b), 27,
        cutoffs=(3,))


def _c_postfix():
    from rapidfuzz_tpu import oracle
    return _check_int_metric(
        "postfix",
        lambda a, b: max(a.size, b.size) - oracle.postfix_sim(a, b), 28,
        cutoffs=(3,))


def _c_jaro():
    from rapidfuzz_tpu import oracle
    from rapidfuzz_tpu.parallel.scan import CorpusScanner

    rng = np.random.default_rng(29)
    qs = _queries(rng)
    corpus = _mixed_corpus(rng, maxlen=96, longmax=256, query=qs[4])
    sc = CorpusScanner(corpus, metric="jaro")
    cases = ([(None, None, q) for q in qs]
             + [(0.25, None, qs[4]), (0.5, None, qs[2])])
    return _verify("jaro", sc, corpus,
                   lambda a, b: 1.0 - oracle.jaro(a, b), cases, f64=True)


def _c_jaro_winkler():
    from rapidfuzz_tpu import oracle
    from rapidfuzz_tpu.parallel.scan import CorpusScanner

    rng = np.random.default_rng(30)
    qs = _queries(rng)
    corpus = _mixed_corpus(rng, maxlen=96, longmax=256, query=qs[4])
    sc = CorpusScanner(corpus, metric="jaro_winkler")
    cases = [(None, None, q) for q in qs] + [(0.25, None, qs[4])]
    return _verify("jaro_winkler", sc, corpus,
                   lambda a, b: 1.0 - oracle.jaro_winkler(a, b), cases,
                   f64=True)


def _c_partial():
    from rapidfuzz_tpu import oracle
    from rapidfuzz_tpu.parallel.scan import CorpusScanner

    rng = np.random.default_rng(31)
    q = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 24))
    corpus = _mixed_corpus(rng, n_ascii=384, n_small=128, n_uni=64,
                           n_bound=36, n_long=32, maxlen=96, longmax=128,
                           query=q)
    corpus = [s for s in corpus if len(s) >= 1]
    sc = CorpusScanner(corpus, metric="partial_ratio")
    q2 = "".join(chr(97 + int(c)) for c in rng.integers(0, 5, 16))
    cases = [(None, None, q), (None, None, q2), (None, None, "a")]
    return _verify("partial_ratio", sc, corpus,
                   lambda a, b: 1.0 - oracle.partial_ratio(a, b), cases,
                   f64=True)


def _c_hamming():
    """Scalar one-shot AND the aligned batch API (no scanner: hamming is
    same-length pairwise)."""
    from rapidfuzz_tpu import oracle
    from rapidfuzz_tpu.distance import hamming

    rng = np.random.default_rng(32)
    n = 0
    t0 = time.perf_counter()
    for L in (0, 1, 31, 32, 64, 127, 256):
        pairs = []
        for _ in range(32):
            a = "".join(chr(97 + int(c)) for c in rng.integers(0, 5, L))
            b = "".join(chr(97 + int(c)) for c in rng.integers(0, 5, L))
            pairs.append((a, b))
        many = np.asarray(hamming.distance_many(
            [a for a, _ in pairs], [b for _, b in pairs]).values)
        for i, (a, b) in enumerate(pairs):
            got = hamming.distance(a, b)
            exp = oracle.hamming(_enc(a), _enc(b))
            assert int(got) == int(exp), (L, a[:12], b[:12], got, exp)
            assert int(many[i]) == int(exp), ("many", L, i, many[i], exp)
            n += 2
    return n, time.perf_counter() - t0


def _c_damerau_band():
    """Damerau under small integer cutoffs on a <=128-char bucket:
    full-corpus oracle verify of the (values, valid) mask, Unicode
    included."""
    from rapidfuzz_tpu import oracle
    from rapidfuzz_tpu.parallel.scan import CorpusScanner

    rng = np.random.default_rng(38)
    base = "".join(chr(97 + int(c)) for c in rng.integers(0, 12, 80))
    corpus = []
    for _ in range(1024):
        s = list(base)
        for _ in range(int(rng.integers(0, 22))):
            op = int(rng.integers(0, 3))
            p = int(rng.integers(0, max(1, len(s) - 1)))
            if op == 0:
                s[p] = chr(97 + int(rng.integers(0, 26)))
            elif op == 1 and p + 1 < len(s):
                s[p], s[p + 1] = s[p + 1], s[p]
            else:
                del s[p]
        corpus.append("".join(s))
    corpus += ["", "a", base, base[:3], "Иванко", "Ивнако" + base[:40]]
    sc = CorpusScanner(corpus, metric="damerau_levenshtein")
    cases = []
    for cut in (0, 2, 3, 7, 12, 15):
        cases.append((cut, None, base))
        cases.append((cut, None, base[:40] + "Иванко"))
    cases.append((16, None, base))
    return _verify("damerau_band", sc, corpus, oracle.damerau, cases)


def _c_jaro_long16k():
    """A 16384-char Jaro bucket through the scanner, full-corpus oracle
    verify."""
    from rapidfuzz_tpu import oracle
    from rapidfuzz_tpu.parallel.scan import CorpusScanner

    rng = np.random.default_rng(39)
    corpus = []
    for _ in range(64):
        L = int(rng.integers(8193, 16385))
        corpus.append("".join(chr(97 + int(c))
                              for c in rng.integers(0, 8, L)))
    corpus[1] = corpus[0][:12000]          # high-similarity pair
    sc = CorpusScanner(corpus, metric="jaro", bucket=16384)
    qs = ["".join(chr(97 + int(c)) for c in rng.integers(0, 8, L))
          for L in (64, 300)] + [corpus[0][:9000]]
    cases = [(None, None, q) for q in qs]
    return _verify("jaro_long16k", sc, corpus,
                   lambda a, b: 1.0 - oracle.jaro(a, b), cases, f64=True)


def _c_jaro_scan_many():
    """Jaro-family scan_many vs oracle."""
    from rapidfuzz_tpu import oracle
    from rapidfuzz_tpu.parallel.scan import CorpusScanner

    rng = np.random.default_rng(35)
    corpus = _mixed_corpus(rng, n_ascii=256, n_small=96, n_uni=48,
                           n_bound=24, n_long=16, maxlen=64, longmax=96)
    sc = CorpusScanner(corpus, metric="jaro_winkler")
    queries = ["", "a"] + [
        "".join(chr(97 + int(c)) for c in rng.integers(0, 26, L))
        for L in (7, 24, 40, 64)]
    t0 = time.perf_counter()
    vals = sc.scan_many(queries)
    t_first = time.perf_counter() - t0
    n = 0
    for qi, q in enumerate(queries):
        qe = _enc(q)
        for i, s in enumerate(corpus):
            exp = 1.0 - oracle.jaro_winkler(qe, _enc(s))
            assert abs(float(vals[qi, i]) - exp) < 1e-9, \
                ("jaro_scan_many", qi, i, vals[qi, i], exp)
            n += 1
    return n, t_first


def _c_scan_many():
    """scan_many (grouped kernel dispatches on a byte corpus on a GPU)
    + topk, vs oracle: the grouped route's VALUES end to end, and the
    deterministic (distance, index) topk tie contract."""
    from rapidfuzz_tpu import oracle
    from rapidfuzz_tpu.parallel.scan import CorpusScanner

    rng = np.random.default_rng(33)
    corpus = _mixed_corpus(rng, n_ascii=384, n_small=128, n_uni=0,
                           n_bound=36, n_long=32, maxlen=96, longmax=256)
    sc = CorpusScanner(corpus, metric="levenshtein")
    queries = ["", "a"] + [
        "".join(chr(97 + int(c)) for c in rng.integers(0, 26, L))
        for L in (7, 16, 31, 32, 33, 48, 63, 64, 65, 96)]
    t0 = time.perf_counter()
    vals = sc.scan_many(queries)
    t_first = time.perf_counter() - t0
    n = 0
    for qi, q in enumerate(queries):
        qe = _enc(q)
        for i, s in enumerate(corpus):
            exp = oracle.levenshtein_uniform(qe, _enc(s))
            assert int(vals[qi, i]) == int(exp), \
                ("scan_many", qi, i, vals[qi, i], exp)
            n += 1
    # topk: values must be the k smallest oracle distances; ids must map
    # to their values; ties broken by original corpus index
    q = queries[7]
    v, ids = sc.topk(q, 16)
    qe = _enc(q)
    d = np.array([oracle.levenshtein_uniform(qe, _enc(s))
                  for s in corpus], np.float64)
    order = np.lexsort((np.arange(d.size), d))[:16]
    assert np.array_equal(np.asarray(v, np.int64), d[order].astype(np.int64)), \
        ("topk values", list(v), list(d[order]))
    assert np.array_equal(np.asarray(ids, np.int64), order), \
        ("topk ids", list(ids), list(order))
    return n + 16, t_first


CHECKS = {
    "levenshtein": _c_levenshtein,
    "wlev": _c_wlev,
    "indel": _c_indel,
    "lcs": _c_lcs,
    "osa": _c_osa,
    "damerau": _c_damerau,
    "prefix": _c_prefix,
    "postfix": _c_postfix,
    "jaro": _c_jaro,
    "jaro_winkler": _c_jaro_winkler,
    "partial": _c_partial,
    "hamming": _c_hamming,
    "scan_many": _c_scan_many,
    "damerau_band": _c_damerau_band,
    "jaro_scan_many": _c_jaro_scan_many,
    "jaro_long16k": _c_jaro_long16k,
}


def run(names=None, log=print):
    """Run the named checks (default: all) in this process; the first
    failure raises."""
    import jax

    log(f"# device {jax.devices()[0]}")
    for name in names or list(CHECKS):
        t0 = time.time()
        n, t_first = CHECKS[name]()
        log(f"OK   {name:<14} {n:6d} pairs oracle-exact, first scan "
            f"{t_first:6.1f}s, total {time.time()-t0:6.1f}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checks", default=None,
                    help="comma-separated subset of: " + ",".join(CHECKS))
    args = ap.parse_args(argv)
    run(args.checks.split(",") if args.checks else None,
        log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
