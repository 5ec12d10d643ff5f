"""Conformance tests for the full metric family.

Golden cases ported from the reference unit tests (SURVEY.md §4), plus
randomized device-vs-oracle sweeps per metric, run on the CPU backend.
"""

import numpy as np
import pytest

from rapidfuzz_tpu import fuzz, oracle
from rapidfuzz_tpu.distance import (damerau_levenshtein, hamming, indel,
                                    jaro, jaro_winkler, lcs_seq,
                                    levenshtein, osa, postfix, prefix)
from data_jaro_golden import NAMES, SCORES


def enc(s):
    if not s:
        return np.empty(0, np.int64)
    return np.frombuffer(s.encode("utf-32-le"), np.uint32).astype(np.int64)


def rand_pairs(rng, n=120, lens=(0, 1, 2, 3, 5, 8, 16, 31, 32, 33, 63, 64,
                                 65, 100, 127, 128, 129), ks=(2, 4, 26)):
    out = []
    for _ in range(n):
        l1, l2 = rng.choice(lens), rng.choice(lens)
        k = int(rng.choice(ks))
        out.append(("".join(chr(97 + c) for c in rng.integers(0, k, l1)),
                    "".join(chr(97 + c) for c in rng.integers(0, k, l2))))
    return out


def check_batch_vs_oracle(module, oracle_fn, pairs, to_dist=None):
    got = module.distance_many([p[0] for p in pairs],
                               [p[1] for p in pairs]).values
    for (s1, s2), g in zip(pairs, got):
        raw = oracle_fn(enc(s1), enc(s2))
        exp = to_dist(raw, len(s1), len(s2)) if to_dist else raw
        assert g == exp, (module.METRIC.name, s1, s2, g, exp)
        # symmetry through the scalar path
        assert module.distance(s1, s2) == exp
        assert module.distance(s2, s1) == exp


# ----------------------------------------------------------------- indel

def test_indel_golden():
    assert indel.distance("aaaa", "aaaa") == 0
    assert indel.similarity("aaaa", "aaaa") == 8
    assert indel.distance("aaaa", "bbbb") == 8
    assert indel.similarity("aaaa", "bbbb") == 0
    assert indel.distance("South Korea", "North Korea") == 4
    assert indel.distance("South Korea", "North Korea", score_cutoff=3) is None
    assert indel.distance("aabc", "cccd") == 6
    assert indel.distance("lewenstein", "levenshtein") == 3
    assert indel.distance("lewenstein", "levenshtein", score_cutoff=2) is None
    assert indel.normalized_similarity("001", "220") == pytest.approx(1 / 3, abs=1e-4)
    assert indel.distance("Иванко", "Петрунко") == 8
    assert indel.distance("ab", "ac") == 2


def test_indel_banded_golden():
    s1 = "ddccbccc"
    s2 = ("a" * 153 + "cca" + "cccacca" + "a" * 8 + "d" + "a" * 8)
    # use the literal long fixture from indel.rs:282-289
    s2 = ("aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa"
          "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaacca"
          "cccaccaaaaaaaadaaaaaaaaccccaccccccaaaaaaaccccaaacccaccccadddaaaaaaaaaaaaaaaaa"
          "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaccccccccacccaaaaaacccaaaaaacc"
          "cacccaaaaaacccdccccccaccccccccccccccccccccccccccccccccccccccccccccccccccccccc"
          "ccccccddddddaaaaaaaaaaaaaaaaaaaaaaaaaacacccaaaaaacccddddaaaaaaaaaaaaaaaaaaaaa"
          "aaaaaaaaccccaaaaaaaaaaccccccaadddaaaaaaaaaaaaaaaaaaaaaacaaaaaa")
    assert indel.distance(s1, s2) == 508
    r = indel.distance_many([s1], [s2]).values
    assert r[0] == 508


def test_indel_random(rng):
    check_batch_vs_oracle(indel, oracle.indel, rand_pairs(rng))


# --------------------------------------------------------------- lcs_seq

def test_lcs_golden():
    assert lcs_seq.distance("a", "a") == 0
    assert lcs_seq.distance("aaaa", "aaaa") == 0
    assert lcs_seq.similarity("aaaa", "aaaa") == 4
    assert lcs_seq.distance("aaaa", "bbbb") == 4
    assert lcs_seq.distance("lewenstein", "levenshtein") == 2
    assert lcs_seq.similarity("lewenstein", "levenshtein") == 9


def test_lcs_random(rng):
    check_batch_vs_oracle(
        lcs_seq, oracle.lcs_seq, rand_pairs(rng),
        to_dist=lambda sim, l1, l2: max(l1, l2) - sim)


# ------------------------------------------------------------------- osa

def test_osa_golden():
    assert osa.distance("", "") == 0
    assert osa.distance("aaaa", "") == 4
    assert osa.distance("aaaa", "", score_cutoff=1) is None
    assert osa.distance("CA", "ABC") == 3
    assert osa.distance("CA", "AC") == 1
    filler = "a" * 64
    s1 = "a" + filler + "CA" + filler + "a"
    s2 = "b" + filler + "AC" + filler + "b"
    assert osa.distance(s1, s2) == 3
    r = osa.distance_many([s1, "CA"], [s2, "AC"]).values
    assert list(r) == [3, 1]
    assert osa.distance("Иванко", "Петрунко") == 5


def test_osa_random(rng):
    check_batch_vs_oracle(osa, oracle.osa, rand_pairs(rng))


# --------------------------------------------------------------- damerau

def test_damerau_golden():
    assert damerau_levenshtein.distance("", "") == 0
    assert damerau_levenshtein.distance("aaaa", "aaaa") == 0
    assert damerau_levenshtein.distance("aaaa", "aaa") == 1
    assert damerau_levenshtein.distance("abaa", "baaa") == 1
    assert damerau_levenshtein.distance("aaaa", "bbbb") == 4
    assert damerau_levenshtein.distance("CA", "ABC") == 2  # true damerau < osa!
    assert damerau_levenshtein.distance("Иванко", "Петрунко") == 5
    assert damerau_levenshtein.distance("ИвaнкoIvan", "Петрунко") == 10


def test_damerau_random(rng):
    check_batch_vs_oracle(damerau_levenshtein, oracle.damerau,
                          rand_pairs(rng, n=80, lens=(0, 1, 2, 3, 5, 8, 16,
                                                      31, 32, 33, 63, 64)))


# --------------------------------------------------------------- hamming

def test_hamming_golden():
    assert hamming.distance("", "") == 0
    assert hamming.distance("hamming", "hamming") == 0
    assert hamming.distance("hamming", "humming") == 1
    assert hamming.distance([1, 2, 4], [1, 2, 3]) == 1
    assert hamming.distance("hamming", "hammers") == 3
    assert hamming.distance("hammers", "hamming", pad=True) == 3
    assert hamming.distance("hammers", "hamming", pad=True, score_cutoff=3) == 3
    assert hamming.distance("hammers", "hamming", pad=True, score_cutoff=2) is None
    assert hamming.distance("hamming", "h香mmüng") == 2
    with pytest.raises(hamming.DifferentLengthArgsError):
        hamming.distance("ham", "hamming")
    assert hamming.distance("ham", "hamming", pad=True) == 4
    assert hamming.distance("ham", "hamming", pad=True, score_cutoff=3) is None
    assert hamming.distance("Friedrich Nietzs", "Jean-Paul Sartre") == 14
    r = hamming.distance_many(["asdf"], ["asxf"]).values
    assert r[0] == 1


def test_hamming_random(rng):
    pairs = rand_pairs(rng)
    got = hamming.distance_many([p[0] for p in pairs],
                                [p[1] for p in pairs], pad=True).values
    for (s1, s2), g in zip(pairs, got):
        assert g == oracle.hamming(enc(s1), enc(s2))


# ------------------------------------------------------- prefix / postfix

def test_prefix_postfix():
    assert prefix.similarity("abcd", "abce") == 3
    assert prefix.distance("abcd", "abce") == 1
    assert postfix.similarity("abcd", "xbcd") == 3
    assert postfix.distance("abcd", "xbcd") == 1
    pairs = [("abc", "abc"), ("", ""), ("a", "b"), ("xyz", "xyab"),
             ("aab", "aab"), ("qqa", "ppa")]
    rp = prefix.distance_many([p[0] for p in pairs], [p[1] for p in pairs]).values
    rs = postfix.distance_many([p[0] for p in pairs], [p[1] for p in pairs]).values
    for (s1, s2), gp, gs in zip(pairs, rp, rs):
        assert gp == max(len(s1), len(s2)) - oracle.prefix_sim(enc(s1), enc(s2))
        assert gs == max(len(s1), len(s2)) - oracle.postfix_sim(enc(s1), enc(s2))


# ------------------------------------------------------------------ jaro

def test_jaro_golden_matrix():
    n = len(NAMES)
    qs, cs, exp = [], [], []
    for i, a in enumerate(NAMES):
        for j, b in enumerate(NAMES):
            qs.append(a)
            cs.append(b)
            exp.append(SCORES[i * n + j])
    got = jaro.similarity_many(qs, cs).values
    for a, b, e, g in zip(qs, cs, exp, got):
        assert g == pytest.approx(e, abs=1e-4), (a, b, e, g)
        # scalar oracle must agree too
        assert jaro.similarity(a, b) == pytest.approx(e, abs=1e-4)
        assert jaro.similarity(b, a) == pytest.approx(g, abs=1e-9)


def test_jaro_cutoff_semantics():
    assert jaro.similarity("james", "robert") == pytest.approx(0.455556, abs=1e-4)
    assert jaro.similarity("james", "robert", score_cutoff=0.5) is None
    assert jaro.distance("james", "robert") == pytest.approx(1 - 0.455556, abs=1e-4)
    assert jaro.distance("Иванко", "Петрунко") == pytest.approx(0.375, abs=1e-4)


def test_jaro_device_vs_oracle_random(rng):
    pairs = rand_pairs(rng, n=150, lens=(0, 1, 2, 3, 4, 5, 8, 16, 31, 32,
                                         33, 63, 64, 65, 100))
    got = jaro.similarity_many([p[0] for p in pairs],
                               [p[1] for p in pairs]).values
    for (s1, s2), g in zip(pairs, got):
        exp = oracle.jaro(enc(s1), enc(s2))
        assert g == exp, (s1, s2, g, exp)  # bit-exact f64


# ---------------------------------------------------------- jaro_winkler

def test_jaro_winkler_golden():
    # derived from the jaro golden matrix + winkler boost semantics
    n = len(NAMES)
    qs, cs, exp = [], [], []
    for i, a in enumerate(NAMES):
        for j, b in enumerate(NAMES):
            s = SCORES[i * n + j]
            p = 0
            for x, y in list(zip(a, b))[:4]:
                if x != y:
                    break
                p += 1
            e = s + p * 0.1 * (1.0 - s) if s > 0.7 else s
            qs.append(a)
            cs.append(b)
            exp.append(e)
    got = jaro_winkler.similarity_many(qs, cs).values
    for a, b, e, g in zip(qs, cs, exp, got):
        assert g == pytest.approx(e, abs=1e-4), (a, b, e, g)
        assert jaro_winkler.similarity(a, b) == pytest.approx(e, abs=1e-4)


def test_jaro_winkler_device_vs_oracle(rng):
    pairs = rand_pairs(rng, n=100, lens=(0, 1, 2, 3, 4, 5, 8, 16, 33, 64))
    got = jaro_winkler.similarity_many([p[0] for p in pairs],
                                       [p[1] for p in pairs]).values
    for (s1, s2), g in zip(pairs, got):
        assert g == oracle.jaro_winkler(enc(s1), enc(s2), 0.1), (s1, s2)
    # custom prefix weight
    assert jaro_winkler.similarity("charles", "charlie", prefix_weight=0.2) \
        == oracle.jaro_winkler(enc("charles"), enc("charlie"), 0.2)


# ------------------------------------------------------------------ fuzz

def test_fuzz_ratio():
    assert fuzz.ratio("this is a test", "this is a test!") \
        == pytest.approx(0.9655, abs=1e-4)
    bc = fuzz.RatioBatchComparator("this is a test")
    assert bc.similarity("this is a test!") == pytest.approx(0.9655, abs=1e-4)
    r = bc.similarities(["this is a test!", "this is a test", "x"]).values
    assert r[0] == pytest.approx(0.9655, abs=1e-4)
    assert r[1] == pytest.approx(1.0)
    # cutoff boundary behaviour (fuzz.rs issues 206/210)
    s = fuzz.ratio("south korea", "north korea")
    assert s == pytest.approx(9 / 11)
    assert fuzz.ratio("south korea", "north korea",
                      score_cutoff=s + 1e-9) is None
    assert fuzz.ratio("south korea", "north korea",
                      score_cutoff=s - 1e-9) == pytest.approx(s)


# ------------------------------------------------------- bytes == chars

def test_bytes_equal_chars():
    """ASCII inputs must score identically as str, bytes, and int lists
    (``_test_distance_ascii``, ``levenshtein.rs:1877-1890``)."""
    from rapidfuzz_tpu.distance import levenshtein

    cases = [("kitten", "sitting"), ("aaaa", "bbbb"), ("", "abc")]
    for mod in (levenshtein, indel, osa, damerau_levenshtein, hamming):
        for s1, s2 in cases:
            if mod is hamming and len(s1) != len(s2):
                continue
            d = mod.distance(s1, s2)
            assert mod.distance(s1.encode(), s2.encode()) == d
            assert mod.distance([ord(c) for c in s1],
                                [ord(c) for c in s2]) == d
    assert jaro.similarity(b"charles", b"charlie") \
        == jaro.similarity("charles", "charlie")


# -------------------------------------------------------- unicode "fuzz"

def test_unicode_fuzz_sweep(rng):
    """Random wide-codepoint strings through every metric, one-shot vs
    batch vs oracle — the in-repo stand-in for the reference's libFuzzer
    targets (``fuzz/fuzz_targets/*.rs``)."""
    from rapidfuzz_tpu.distance import levenshtein

    planes = [(0x20, 0x7F), (0x400, 0x4FF), (0x4E00, 0x4E80),
              (0x1F600, 0x1F640)]
    pairs = []
    for i in range(60):
        lo, hi = planes[i % len(planes)]
        l1, l2 = rng.integers(0, 20), rng.integers(0, 20)
        s1 = "".join(chr(int(c)) for c in rng.integers(lo, hi, l1))
        s2 = "".join(chr(int(c)) for c in rng.integers(lo, hi, l2))
        pairs.append((s1, s2))
    mods = [(levenshtein, oracle.levenshtein_uniform, None),
            (indel, oracle.indel, None),
            (osa, oracle.osa, None),
            (damerau_levenshtein, oracle.damerau, None),
            (lcs_seq, oracle.lcs_seq,
             lambda sim, l1, l2: max(l1, l2) - sim)]
    for mod, ofn, to_dist in mods:
        got = mod.distance_many([p[0] for p in pairs],
                                [p[1] for p in pairs]).values
        for (s1, s2), g in zip(pairs, got):
            raw = ofn(enc(s1), enc(s2))
            exp = to_dist(raw, len(s1), len(s2)) if to_dist else raw
            assert g == exp, (mod, s1, s2, g, exp)
            assert mod.distance(s1, s2) == exp
    for s1, s2 in pairs[:20]:
        assert jaro.similarity(s1, s2) == oracle.jaro(enc(s1), enc(s2))
        assert fuzz.ratio(s1, s2) == pytest.approx(
            1.0 - (oracle.indel(enc(s1), enc(s2))
                   / max(len(s1) + len(s2), 1)), abs=1e-12)


# ------------------------------------------------- device scalar backend

def test_device_scalar_backend(monkeypatch):
    """RAPIDFUZZ_TPU_SCALAR_BACKEND=device routes one-shot scalars through
    the device batch kernels; results must match the oracle path."""
    from rapidfuzz_tpu.distance import levenshtein
    from rapidfuzz_tpu.distance.levenshtein import WeightTable

    cases = [("kitten", "sitting"), ("", "abc"), ("abcd", "abcd"),
             ("Иванко", "Петрунко")]
    expected = {}
    for mod in (indel, osa, damerau_levenshtein, lcs_seq):
        for a, b in cases:
            expected[(mod.__name__, a, b)] = mod.distance(a, b)
    lev_exp = [levenshtein.distance(a, b) for a, b in cases]
    w_exp = levenshtein.distance("kitten", "sitting",
                                 weights=WeightTable(1, 1, 2))

    monkeypatch.setenv("RAPIDFUZZ_TPU_SCALAR_BACKEND", "device")
    for mod in (indel, osa, damerau_levenshtein, lcs_seq):
        for a, b in cases:
            assert mod.distance(a, b) == expected[(mod.__name__, a, b)]
    for (a, b), e in zip(cases, lev_exp):
        assert levenshtein.distance(a, b) == e
    assert levenshtein.distance("kitten", "sitting",
                                weights=WeightTable(1, 1, 2)) == w_exp


def test_weights_tuple_coercion():
    """Plain ``(ins, del, sub)`` tuples are accepted everywhere a
    ``WeightTable`` is (rapidfuzz-python drop-in ergonomics; the crate
    only takes the struct form, ``levenshtein.rs:129-148``)."""
    from rapidfuzz_tpu.distance import levenshtein
    from rapidfuzz_tpu.distance.levenshtein import WeightTable

    wt = WeightTable(1, 1, 2)
    assert (levenshtein.distance("kitten", "sitting", weights=(1, 1, 2))
            == levenshtein.distance("kitten", "sitting", weights=wt) == 5)
    assert levenshtein.similarity("kitten", "sitting", weights=[2, 3, 4]) \
        == levenshtein.similarity("kitten", "sitting",
                                  weights=WeightTable(2, 3, 4))
    assert levenshtein.maximum(3, 5, (1, 1, 2)) \
        == levenshtein.maximum(3, 5, WeightTable(1, 1, 2))
    a = levenshtein.Args().weights((1, 1, 2))
    assert a.weights_ == wt
    bc = levenshtein.BatchComparator("kitten", weights=(1, 1, 2))
    assert bc.distance("sitting") == 5
    got = levenshtein.distance_many(
        ["kitten"] * 2, ["sitting", "mitten"], weights=(1, 1, 2))
    exp = levenshtein.distance_many(
        ["kitten"] * 2, ["sitting", "mitten"], weights=wt)
    np.testing.assert_array_equal(got.values, exp.values)


# ---------------------------------------------------- batch comparators

def test_batch_comparators_match_scalar():
    corpus = ["abcd", "abce", "", "xbcd", "dcba", "abcdabcd"]
    for mod in (indel, lcs_seq, osa, damerau_levenshtein, prefix, postfix):
        bc = mod.BatchComparator("abcd")
        got = bc.distances(corpus).values
        for s, g in zip(corpus, got):
            assert g == mod.distance("abcd", s), (mod, s)
    bj = jaro.BatchComparator("abcd")
    got = bj.similarities(corpus).values
    for s, g in zip(corpus, got):
        assert g == jaro.similarity("abcd", s)


def test_batch_comparator_scalar_fast_path_matches_encoded():
    """Scalar BatchComparator calls with str queries ride the C one-shot
    route (the reference keeps its BatchComparator the fastest scalar
    path, ``levenshtein.rs:1625-1657``); an encoded-array query must give
    identical results through every method, including jaro_winkler's
    prefix_weight plumbing and fuzz's RatioBatchComparator."""
    import rapidfuzz_tpu.fuzz as fz
    pairs = [("abcd", "axbcd"), ("", "abc"), ("martha", "marhta"),
             ("kitten", "sitting")]
    mods = (levenshtein, indel, lcs_seq, osa, damerau_levenshtein,
            prefix, postfix, jaro, jaro_winkler)
    for mod in mods:
        for a, b in pairs:
            bc, enc = mod.BatchComparator(a), mod.BatchComparator(
                [ord(c) for c in a])
            for meth in ("distance", "similarity",
                         "normalized_distance", "normalized_similarity"):
                if not hasattr(bc, meth):
                    continue
                v1 = getattr(bc, meth)(b)
                v2 = getattr(enc, meth)([ord(c) for c in b])
                assert abs(float(v1) - float(v2)) < 1e-12, (mod, meth, a, b)
    jw = jaro_winkler.BatchComparator("martha", prefix_weight=0.2)
    jw2 = jaro_winkler.BatchComparator([ord(c) for c in "martha"],
                                       prefix_weight=0.2)
    assert jw.similarity("marhta") == jw2.similarity(
        [ord(c) for c in "marhta"])
    rb = fz.RatioBatchComparator("this is a test")
    rb2 = fz.RatioBatchComparator([ord(c) for c in "this is a test"])
    assert rb.similarity("this is a test!") == rb2.similarity(
        [ord(c) for c in "this is a test!"])


# ------------------------------------------- reference regression sweep

def test_indel_banded_regressions_full():
    """Remaining ``test_banded_implementation`` cases (indel.rs:818-848):
    the cutoff ladder on the 508 fixture and the second 231-distance
    pair."""
    s1 = ("ddccbccc")
    s2 = ("aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa"
          "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaacca"
          "cccaccaaaaaaaadaaaaaaaaccccaccccccaaaaaaaccccaaacccaccccadddaaaaaaaaaaaaaaaaa"
          "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaccccccccacccaaaaaacccaaaaaacc"
          "cacccaaaaaacccdccccccaccccccccccccccccccccccccccccccccccccccccccccccccccccccc"
          "ccccccddddddaaaaaaaaaaaaaaaaaaaaaaaaaacacccaaaaaacccddddaaaaaaaaaaaaaaaaaaaaa"
          "aaaaaaaaccccaaaaaaaaaaccccccaadddaaaaaaaaaaaaaaaaaaaaaacaaaaaa")
    assert indel.distance(s1, s2, score_cutoff=508) == 508
    assert indel.distance(s1, s2, score_cutoff=507) is None
    assert indel.distance(s1, s2, score_cutoff=10**9) == 508

    t1 = ("bbbdbbmbbbbbbbbbBbfbbbbbbbbbbbbbbbbbbbrbbbbbrbbbbbdbnbbbjbhbbbbbbbbbhbbb"
          "bbCbobbbxbbbbbkbbbAbxbbwbbbtbcbbbbebbiblbbbbqbbbbbbpbbbbbbubbbkbbDbbbhbkbC"
          "bbgbbrbbbbbbbbbbbkbyvbbsbAbbbbz")
    t2 = "jaaagaaqyaaaanrCfwaaxaeahtaaaCzaaaspaaBkvaaaaqDaacndaaeolwiaaauaaaaaaamA"
    assert indel.distance(t1, t2) == 231
    assert indel.distance(t2, t1) == 231                       # symmetry
    assert indel.distance_many([t1], [t2]).values[0] == 231    # batch==scalar


def test_jaro_fuzzing_regression_wide():
    """``jaro.rs:1201-1218`` fuzzing regression: long strings with >u8
    codepoints mixed in; batch == scalar == symmetric, and the score sits
    within the reference's asserted bound (|dist - 0.1| <= 0.32144)."""
    s1 = ("afddddddddddddddddddddddddddddddddddddddddadacccccccdddddddddd%,"
          "ccaa{1}ccccdccccccccccccccccccccc"
          "cccccccccccccccccccccccccccccccccccccccccccccccczcecccccccccccccc"
          "cccccccccccccccccccccccccccccccc"
          "cccccccccdddddddd디ccc디Gcddddcccccccccccccccccccccccccccc"
          "cccccccccccccccccccccccccccccccccccccaccccccccccccc"
          "ccccccccccccccccccccccccccccccccccccccccccccea,"
          "ccccccccccccccccccccccccccccccccccccccc")
    s2 = ("cccccccccccccccccccccccccccccccccccccccccccccccccccccccccccccccccc"
          "ccccccccccccccccccccccccccddddd"
          "dddddddddddddddddddddddddddddf,ccczюec*ceч;e,")
    d = jaro.distance(s1, s2, score_cutoff=1.0)
    assert d is not None and abs(d - 0.1) <= 0.32144
    assert jaro.distance(s2, s1, score_cutoff=1.0) == pytest.approx(d, abs=1e-12)
    bc = jaro.BatchComparator(s1)
    assert bc.distances([s2]).values[0] == pytest.approx(d, abs=1e-12)


def test_damerau_normalized_golden():
    """``damerau_levenshtein.rs:646-690`` normalized-similarity goldens."""
    cases = [("aaaa", "aaaa", 1.0), ("aaaa", "aaa", 0.75),
             ("aaaa", "aaab", 0.75), ("abaa", "baaa", 0.75),
             ("aaaa", "bbbb", 0.0)]
    for a, b, exp in cases:
        got = damerau_levenshtein.normalized_similarity(a, b,
                                                        score_cutoff=0.0)
        assert got == pytest.approx(exp, abs=1e-4), (a, b)
        got2 = damerau_levenshtein.normalized_similarity_many(
            [a], [b], score_cutoff=0.0).values[0]
        assert got2 == pytest.approx(exp, abs=1e-4), (a, b)


def test_u64_i64_hash_disambiguation():
    """The reference's ``Hash`` enum keeps a u64 value distinct from the
    i64 value with the same bit pattern (``lib.rs:102-120``); the interned
    codec preserves that across separate encode calls."""
    u = np.array([0xFFFFFFFFFFFFFFFF], np.uint64)       # 2^64 - 1
    i = np.array([-1], np.int64)                        # same bit pattern
    assert levenshtein.distance(u, i) == 1              # NOT equal
    assert levenshtein.distance(u, u) == 0              # self-equal
    assert levenshtein.distance(i, i) == 0
    # equality across separate calls + mixed widths below i64::MAX
    assert levenshtein.distance(np.array([7], np.uint64),
                                np.array([7], np.int64)) == 0
    # python ints spanning the full domain
    assert levenshtein.distance([2 ** 64 - 1, -1], [2 ** 64 - 1, -1]) == 0
    assert levenshtein.distance([2 ** 64 - 1], [-1]) == 1
    # batch path agrees with scalar
    r = levenshtein.distance_many([u], [i]).values
    assert r[0] == 1


def test_batch_api_scan_route(monkeypatch):
    """distance_many([q], corpus) / BatchComparator.distances route large
    one-vs-many batches through the corpus scan on GPU (>= SCAN_MIN
    candidates: the scan kernel for levenshtein and the weights that
    reduce to indel, the XLA route for osa) with results identical to the
    XLA pair-kernel path."""
    import numpy as np

    from rapidfuzz_tpu.distance import _int_metric
    from rapidfuzz_tpu.distance import levenshtein as lev_mod
    from rapidfuzz_tpu.distance import osa as osa_mod

    rng = np.random.default_rng(61)
    letters = list("abcdef")
    n = _int_metric.SCAN_MIN + 50
    corpus = ["".join(rng.choice(letters, int(k)))
              for k in rng.integers(0, 30, n)]
    q = "fedcba"
    ref = np.asarray(lev_mod.BatchComparator(q).distances(corpus).values)
    ref_o = np.asarray(osa_mod.BatchComparator(q).distances(corpus).values)
    refw = np.asarray(lev_mod.BatchComparator(
        q, weights=lev_mod.WeightTable(1, 1, 2)).distances(corpus).values)
    _gpu_routes(monkeypatch)
    np.testing.assert_array_equal(
        np.asarray(lev_mod.BatchComparator(q).distances(corpus).values),
        ref)
    np.testing.assert_array_equal(
        np.asarray(osa_mod.BatchComparator(q).distances(corpus).values),
        ref_o)
    np.testing.assert_array_equal(
        np.asarray(lev_mod.BatchComparator(
            q, weights=lev_mod.WeightTable(1, 1, 2))
            .distances(corpus).values), refw)


def test_jaro_batch_api_scan_route(monkeypatch):
    """Jaro-family *_many batches >= SCAN_MIN also ride the corpus scan
    on GPU (its XLA route);
    scores match the XLA route to <= 1 ulp (distance form round-trip)."""
    import numpy as np

    from rapidfuzz_tpu.distance import _int_metric
    from rapidfuzz_tpu.distance import jaro as jaro_mod
    from rapidfuzz_tpu.distance import jaro_winkler as jw_mod

    rng = np.random.default_rng(71)
    letters = list("abcdef")
    corpus = ["".join(rng.choice(letters, int(k)))
              for k in rng.integers(0, 30, _int_metric.SCAN_MIN + 20)]
    q = "fedcba"
    ref_j = np.asarray(jaro_mod.similarity_many([q], corpus).values)
    ref_w = np.asarray(jw_mod.similarity_many(
        [q], corpus, prefix_weight=0.2).values)
    _gpu_routes(monkeypatch)
    got_j = np.asarray(jaro_mod.similarity_many([q], corpus).values)
    got_w = np.asarray(jw_mod.similarity_many(
        [q], corpus, prefix_weight=0.2).values)
    assert np.abs(got_j - ref_j).max() < 1e-15
    assert np.abs(got_w - ref_w).max() < 1e-15


def _gpu_routes(monkeypatch):
    """Route as on a GPU, the scan kernel in Pallas' interpreter (the
    ``kernel_route`` fixture, applied mid-test after the reference
    values)."""
    from rapidfuzz_tpu.ops import route, scan_kernel

    monkeypatch.setattr(route, "mesh_platform", lambda mesh: "gpu")
    monkeypatch.setattr(route, "default_platform", lambda: "gpu")
    monkeypatch.setattr(scan_kernel, "INTERPRET", True)
