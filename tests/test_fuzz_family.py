"""Extended fuzz-scorer family.

These scorers are absent from the reference crate (``fuzz.rs:207-213``
comments out their tests); semantics follow the wider rapidfuzz
ecosystem, documented in ``rapidfuzz_tpu/fuzz.py``, with scores kept in
[0, 1] like the crate's ``ratio``.  ``partial_ratio`` is verified against
a brute-force window sweep built on the scalar ``ratio``.
"""

import numpy as np
import pytest

from rapidfuzz_tpu import fuzz
from rapidfuzz_tpu.models import process


def brute_partial(s1, s2):
    if len(s1) > len(s2):
        s1, s2 = s2, s1
    m, n = len(s1), len(s2)
    if m == 0:
        return 1.0 if n == 0 else 0.0
    best = 0.0
    for i in range(1, n + m):
        w = s2[max(0, i - m):min(n, i)]
        best = max(best, fuzz.ratio(s1, w))
    return best


def test_partial_ratio_brute_force():
    rng = np.random.default_rng(5)
    for _ in range(40):
        n1, n2 = rng.integers(0, 18, 2)
        s1 = "".join(rng.choice(list("abc"), n1))
        s2 = "".join(rng.choice(list("abc"), n2))
        got = fuzz.partial_ratio(s1, s2)
        exp = brute_partial(s1, s2)
        assert got == pytest.approx(exp, abs=1e-12), (s1, s2)


def test_partial_ratio_basics():
    assert fuzz.partial_ratio("this is a test", "this is a test!") == 1.0
    assert fuzz.partial_ratio("abc", "xxabcxx") == 1.0
    # overhanging edge alignment counts (window shorter than the needle)
    assert fuzz.partial_ratio("ab", "bx") == pytest.approx(2 / 3)
    assert fuzz.partial_ratio("", "") == 1.0
    assert fuzz.partial_ratio("", "x") == 0.0
    assert fuzz.partial_ratio("abc", "abc", score_cutoff=0.9) == 1.0
    assert fuzz.partial_ratio("abc", "xyz", score_cutoff=0.9) is None


def test_partial_ratio_alignment():
    a = fuzz.partial_ratio_alignment("needle", "say needle here")
    assert (a.src_start, a.src_end) == (0, 6)
    assert "say needle here"[a.dest_start:a.dest_end] == "needle"
    assert a.score == 1.0
    # swapped argument order mirrors the alignment
    b = fuzz.partial_ratio_alignment("say needle here", "needle")
    assert "say needle here"[b.src_start:b.src_end] == "needle"
    assert (b.dest_start, b.dest_end) == (0, 6)
    assert fuzz.partial_ratio_alignment("abc", "xyz",
                                        score_cutoff=0.9) is None
    # the claimed window really scores `score`
    s1, s2 = "kitten inside", "a sitting kitten"
    al = fuzz.partial_ratio_alignment(s1, s2)
    assert fuzz.ratio(s1[al.src_start:al.src_end],
                      s2[al.dest_start:al.dest_end]) == pytest.approx(
        al.score)


def test_token_sort_ratio():
    assert fuzz.token_sort_ratio("fuzzy wuzzy was a bear",
                                 "wuzzy fuzzy was a bear") == 1.0
    assert fuzz.token_sort_ratio("a b c", "c  b\ta") == 1.0
    # equals plain ratio on the sorted joins
    s1, s2 = "great new world", "new world order"
    exp = fuzz.ratio(" ".join(sorted(s1.split())),
                     " ".join(sorted(s2.split())))
    assert fuzz.token_sort_ratio(s1, s2) == pytest.approx(exp)


def test_token_set_ratio():
    assert fuzz.token_set_ratio("fuzzy was a bear",
                                "fuzzy fuzzy was a bear") == 1.0
    # subset of tokens -> intersection vs join hits 1.0
    assert fuzz.token_set_ratio("a b", "a b c d") == 1.0
    assert fuzz.token_set_ratio("abc", "xyz") == fuzz.ratio("abc", "xyz")
    assert fuzz.token_ratio("a b", "b a") == 1.0


def test_partial_token_scorers():
    assert fuzz.partial_token_set_ratio("shared x", "shared y") == 1.0
    assert fuzz.partial_token_set_ratio("aa bb", "cc dd") == \
        pytest.approx(fuzz.partial_ratio("aa bb", "cc dd"))
    assert fuzz.partial_token_sort_ratio("new test", "test new extra") == 1.0
    assert fuzz.partial_token_ratio("shared x", "shared y") == 1.0


def test_wratio_qratio():
    # short branch: len_ratio < 1.5 -> max(ratio, token_ratio * 0.95)
    s1, s2 = "new world order", "the new order world"
    exp = max(fuzz.ratio(s1, s2), fuzz.token_ratio(s1, s2) * 0.95)
    assert fuzz.WRatio(s1, s2) == pytest.approx(exp)
    # long branch: partial scorers scaled by 0.9
    s1, s2 = "this is a test", "this is a new test!!!"
    exp = max(fuzz.ratio(s1, s2), fuzz.partial_ratio(s1, s2) * 0.9,
              fuzz.partial_token_ratio(s1, s2) * 0.95 * 0.9)
    assert fuzz.WRatio(s1, s2) == pytest.approx(exp)
    assert fuzz.WRatio("", "") == 1.0
    assert fuzz.WRatio("", "x") == 0.0
    assert fuzz.QRatio("abc", "abc") == 1.0
    assert fuzz.WRatio("abc", "xyz", score_cutoff=0.5) is None


def test_default_process():
    assert fuzz.default_process("  Hello, WORLD!!") == "hello  world"
    assert fuzz.token_sort_ratio("Fuzzy...Wuzzy", "wuzzy fuzzy",
                                 processor=fuzz.default_process) == 1.0
    assert fuzz.WRatio("C++ IS GREAT", "c   is great",
                       processor=fuzz.default_process) == 1.0


def test_bytes_tokens():
    assert fuzz.token_sort_ratio(b"beta alpha", b"alpha beta") == 1.0
    assert fuzz.partial_token_set_ratio(b"x shared", b"y shared") == 1.0


def test_process_integration():
    choices = ["new york jets", "new york giants", "dallas cowboys"]
    best = process.extract_one("jets new york", choices,
                               scorer="token_sort_ratio")
    assert best[0] == "new york jets" and best[1] == 1.0
    res = process.cdist(["jets"], choices, scorer="partial_ratio")
    assert res.values[0, 0] == 1.0
    with pytest.raises(ValueError, match="normalized_similarity"):
        process.cdist(["a"], choices, scorer="WRatio",
                      score_kind="distance")
    # callables pass straight through
    best = process.extract_one("jets", choices, scorer=fuzz.WRatio)
    assert best[0] == "new york jets"


def test_long_needle_chunked_windows():
    # long inputs exercise the chunked window batches
    rng = np.random.default_rng(9)
    s1 = "".join(rng.choice(list("abcdef"), 300))
    s2 = "".join(rng.choice(list("abcdef"), 90))
    mid = s1[100:190]
    assert fuzz.partial_ratio(mid, s1) == 1.0
    got = fuzz.partial_ratio(s2, s1)
    assert 0.0 < got <= 1.0


def test_many_forms_match_scalar():
    """Every *_many batch form equals the scalar scorer elementwise."""
    rng = np.random.default_rng(21)
    words = ["new", "york", "jets", "giants", "dallas", "cowboys", "a",
             "яблоко", "test!!!"]
    choices = []
    for _ in range(17):
        n = rng.integers(0, 5)
        choices.append(" ".join(rng.choice(words, n)))
    choices += ["", "new york jets", "jets  new\tyork"]
    queries = ["jets new york", "", "dallas", "яблоко test!!! a",
               "completely different string altogether"]
    for scalar, many in [
            (fuzz.ratio, fuzz.ratio_many),
            (fuzz.partial_ratio, fuzz.partial_ratio_many),
            (fuzz.token_sort_ratio, fuzz.token_sort_ratio_many),
            (fuzz.token_set_ratio, fuzz.token_set_ratio_many),
            (fuzz.token_ratio, fuzz.token_ratio_many),
            (fuzz.partial_token_sort_ratio,
             fuzz.partial_token_sort_ratio_many),
            (fuzz.partial_token_set_ratio,
             fuzz.partial_token_set_ratio_many),
            (fuzz.partial_token_ratio, fuzz.partial_token_ratio_many),
            (fuzz.WRatio, fuzz.WRatio_many),
            (fuzz.QRatio, fuzz.QRatio_many)]:
        for q in queries:
            got = many(q, choices).values
            exp = [scalar(q, c) for c in choices]
            assert np.allclose(got, exp, atol=1e-12), (
                scalar.__name__, q,
                [(c, g, e) for c, g, e in zip(choices, got, exp)
                 if abs(g - e) > 1e-12][:3])


def test_many_cutoff_and_processor():
    res = fuzz.WRatio_many("new york", ["new york", "boston"],
                           score_cutoff=0.9)
    assert res.valid.tolist() == [True, False]
    res = fuzz.token_sort_ratio_many("Fuzzy...Wuzzy", ["wuzzy fuzzy"],
                                     processor=fuzz.default_process)
    assert res.values[0] == 1.0


def test_process_uses_many_forms():
    choices = ["new york jets", "new york giants", "dallas cowboys"]
    res = process.cdist(["jets new york"], choices, scorer="WRatio")
    exp = [fuzz.WRatio("jets new york", c) for c in choices]
    assert np.allclose(res.values[0], exp)
    best = process.extract_one("jets", choices, scorer=fuzz.partial_ratio)
    assert best[0] == "new york jets" and best[1] == 1.0


def test_extract_iter_and_processor():
    choices = ["New York Jets!!", "new york giants", "dallas cowboys"]
    hits = list(process.extract_iter(
        "jets NEW york", choices, scorer="token_sort_ratio",
        score_cutoff=0.9, processor=fuzz.default_process))
    assert hits == [("New York Jets!!", 1.0, 0)]
    res = process.cdist(["C++ great"], ["c   great"],
                        scorer="token_sort_ratio",
                        processor=fuzz.default_process)
    assert res.values[0, 0] == 1.0


def test_user_callable_shadowing_fuzz_name():
    """A user scorer that merely shares a fuzz function's name must NOT
    be hijacked by the batch *_many shortcut (review regression)."""
    def partial_ratio(s1, s2):          # noqa: shadows fuzz.partial_ratio
        return 0.5
    res = process.cdist(["a"], ["a", "b"], scorer=partial_ratio)
    assert res.values.tolist() == [[0.5, 0.5]]


def test_partial_ratio_many_matches_scalar():
    """``partial_ratio_many``'s batched window sweep returns bit-identical
    scores to the scalar path (incl. the short-candidate role swap and
    empty candidates), and its cutoff masks them."""
    rng = np.random.default_rng(12)
    letters = list("abcdefgh")
    q = "".join(rng.choice(letters, 9))
    choices = ["".join(rng.choice(letters, int(n)))
               for n in rng.integers(0, 30, 120)] + ["", q, q * 3, "ab"]
    got = fuzz.partial_ratio_many(q, choices).values
    exp = np.array([fuzz.partial_ratio(q, c) for c in choices])
    assert (got == exp).all()
    r = fuzz.partial_ratio_many(q, choices, score_cutoff=0.8)
    assert (r.valid == (got >= 0.8)).all()


def test_partial_ratio_alignment_many():
    """Batch alignments: scores AND spans equal the pairwise host sweep
    (incl. short/empty candidates whose roles swap, and cutoff
    filtering)."""
    rng = np.random.default_rng(13)
    letters = list("abcdefg")
    q = "".join(rng.choice(letters, 9))
    choices = ["".join(rng.choice(letters, int(n)))
               for n in rng.integers(0, 30, 100)] + ["", q, q * 2, "ab"]
    exp = [fuzz.partial_ratio_alignment(q, c) for c in choices]
    got = fuzz.partial_ratio_alignment_many(q, choices)
    for g, e, c in zip(got, exp, choices):
        assert g == e, (c, g, e)
    cut = fuzz.partial_ratio_alignment_many(q, choices, score_cutoff=0.8)
    for g, e in zip(cut, exp):
        assert g == (e if e.score >= 0.8 else None)


def test_partial_ratio_vs_cpp_oracle():
    """Production partial_ratio (batched LCS window sweep) vs the
    independent brute-force C++ oracle: bit-exact."""
    from rapidfuzz_tpu import oracle
    from rapidfuzz_tpu.utils import codec

    rng = np.random.default_rng(81)
    for _ in range(120):
        m, n = int(rng.integers(0, 18)), int(rng.integers(0, 36))
        a = rng.integers(97, 104, m).astype(np.int64)
        b = rng.integers(97, 104, n).astype(np.int64)
        assert fuzz.partial_ratio(a, b) == oracle.partial_ratio(
            codec.encode_one(a), codec.encode_one(b))


def test_fuzz_family_metamorphic():
    """Cross-scorer properties on random inputs: identity scores 1.0,
    symmetry, token_sort invariance under token permutation, and
    token_set_ratio >= token_sort_ratio (set algebra only relaxes)."""
    rng = np.random.default_rng(113)
    letters = list("abcd ")
    scorers = [fuzz.ratio, fuzz.partial_ratio, fuzz.token_sort_ratio,
               fuzz.token_set_ratio, fuzz.token_ratio, fuzz.WRatio,
               fuzz.QRatio]
    for _ in range(40):
        s1 = "".join(rng.choice(letters, int(rng.integers(0, 30))))
        s2 = "".join(rng.choice(letters, int(rng.integers(0, 30))))
        for f in scorers:
            assert f(s1, s1) == 1.0, (f.__name__, s1)
            if f is fuzz.partial_ratio and len(s1) == len(s2):
                # equal lengths: the ecosystem convention slides the
                # FIRST argument's windows, so partial_ratio is only
                # symmetric when one side is strictly shorter
                continue
            assert f(s1, s2) == f(s2, s1), (f.__name__, s1, s2)
        toks = s1.split()
        perm = " ".join(rng.permutation(toks).tolist())
        assert fuzz.token_sort_ratio(s1, perm) == 1.0, (s1, perm)
        assert (fuzz.token_set_ratio(s1, s2)
                >= fuzz.token_sort_ratio(s1, s2) - 1e-12), (s1, s2)
