"""Sharded scan / top-k / process-layer tests on the virtual 8-CPU mesh."""

import numpy as np
import pytest

import jax

from rapidfuzz_tpu.parallel import CorpusScanner, data_mesh, topk_merge
from rapidfuzz_tpu.distance import levenshtein as lev
from rapidfuzz_tpu.models import cdist, extract, extract_one


@pytest.fixture(scope="module")
def mesh():
    return data_mesh(8, platform="cpu")


def test_mesh(mesh):
    assert mesh.shape == {"data": 8}


def test_topk_merge(mesh):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    scores = np.arange(64, dtype=np.float32)
    np.random.default_rng(0).shuffle(scores)
    idx = np.arange(64, dtype=np.int32)
    s = jax.device_put(scores, NamedSharding(mesh, P("data")))
    i = jax.device_put(idx, NamedSharding(mesh, P("data")))
    vals, ids = topk_merge(s, i, 5, mesh, largest=True)
    np.testing.assert_array_equal(np.asarray(vals), [63, 62, 61, 60, 59])
    assert all(scores[j] == v for j, v in zip(np.asarray(ids),
                                              np.asarray(vals)))


def test_topk_merge_rows(mesh):
    """Row-wise merge of [rows, C] scores sharded along C: each row's k
    smallest, equal scores in index order (the scanner's tie rule)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(1)
    scores = rng.integers(0, 6, (3, 64)).astype(np.float32)
    s = jax.device_put(scores, NamedSharding(mesh, P(None, "data")))
    i = jax.device_put(np.arange(64, dtype=np.int32),
                       NamedSharding(mesh, P("data")))
    vals, ids = topk_merge(s, i, 7, mesh, largest=False)
    for r in range(3):
        exp = np.lexsort((np.arange(64), scores[r]))[:7]
        np.testing.assert_array_equal(np.asarray(ids)[r], exp)
        np.testing.assert_array_equal(np.asarray(vals)[r], scores[r][exp])


def test_corpus_scanner(mesh):
    corpus = ["apple", "apply", "ape", "maple", "orange", "grape",
              "pineapple", "app", "", "apple"] * 3
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=mesh, bucket=32)
    d = sc.distances("apple")
    for s, g in zip(corpus, d):
        assert g == lev.distance("apple", s)
    vals, ids = sc.topk("apple", k=4)
    assert vals[0] == 0 and corpus[ids[0]] == "apple"
    assert sorted(vals) == list(vals)


def test_corpus_scanner_metrics(mesh):
    corpus = ["abcd", "abdc", "xxxx", "ab"]
    for metric, expected in [
        ("levenshtein", [0, 2, 4, 2]),
        ("osa", [0, 1, 4, 2]),
        ("damerau_levenshtein", [0, 1, 4, 2]),
        ("indel", [0, 2, 8, 2]),
        ("lcs_seq", [0, 1, 4, 2]),
        ("hamming", [0, 2, 4, 2]),
        ("prefix", [0, 2, 4, 2]),
        ("postfix", [0, 4, 4, 4]),
    ]:
        sc = CorpusScanner(corpus, metric=metric, mesh=mesh, bucket=32)
        np.testing.assert_array_equal(sc.distances("abcd"), expected)


def test_corpus_scanner_jaro_family(mesh):
    from rapidfuzz_tpu.distance import jaro, jaro_winkler

    corpus = ["apple", "apples", "maple", "orange", "", "charlie"]
    for metric, mod, kw in [("jaro", jaro, {}),
                            ("jaro_winkler", jaro_winkler, {})]:
        sc = CorpusScanner(corpus, metric=metric, mesh=mesh, bucket=32)
        d = sc.distances("charles")
        for s, g in zip(corpus, d):
            assert g == mod.distance("charles", s), (metric, s)
        vals, ids = sc.topk("charles", k=2)
        assert corpus[ids[0]] == "charlie"
        assert vals[0] == mod.distance("charles", "charlie")
    # custom prefix weight flows through
    sc = CorpusScanner(corpus, metric="jaro_winkler", mesh=mesh, bucket=32,
                       prefix_weight=0.2)
    d = sc.distances("charles")
    assert d[5] == jaro_winkler.distance("charles", "charlie",
                                         prefix_weight=0.2)


def test_query_outside_corpus_domain(mesh):
    """Regression: a query with negative/out-of-int32 chars against an
    UN-remapped corpus must not be vocab-remapped alone (that broke char
    equality and returned distance 3 instead of 1 here)."""
    sc = CorpusScanner(["ab", "xy"], metric="levenshtein", mesh=mesh,
                       bucket=32)
    np.testing.assert_array_equal(
        sc.distances(np.array([-7, 97, 98])), [1, 3])
    np.testing.assert_array_equal(
        sc.distances(np.array([2 ** 40, 97, 98])), [1, 3])


def test_corpus_scanner_vocab_remap(mesh):
    """Corpus elements above int32 go through a shared dense vocab; queries
    must map through the same vocab (SURVEY.md hard part #4)."""
    big = 1 << 40
    corpus = [[big, big + 1], [big, big + 1, big + 2], [7, 8]]
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=mesh, bucket=32)
    np.testing.assert_array_equal(sc.distances([big, big + 1]), [0, 1, 2])
    # query chars absent from the corpus can never match
    np.testing.assert_array_equal(sc.distances([big + 99, big + 1]),
                                  [1, 2, 2])


def test_corpus_scanner_cutoff(mesh):
    corpus = ["apple", "apply", "ape", "maple", "orange", "grape", ""]
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=mesh, bucket=32)
    res = sc.distances("apple", score_cutoff=2)
    assert res.tolist() == [lev.distance("apple", s, score_cutoff=2)
                            for s in corpus]
    vals, ids = sc.topk("apple", k=10, score_cutoff=2)
    assert len(vals) == 4    # apple, apply, ape, maple
    assert all(v <= 2 for v in vals)
    assert corpus[ids[0]] == "apple" and vals[0] == 0


def test_corpus_scanner_weighted(mesh):
    from rapidfuzz_tpu.distance.levenshtein import WeightTable

    corpus = ["sitting", "mitten", "kitten", "", "kittenkitten"]
    for w in [WeightTable(1, 2, 3), WeightTable(3, 2, 1), WeightTable(1, 1, 2),
              WeightTable(2, 2, 2), WeightTable(0, 0, 1), WeightTable(2, 2, 5)]:
        sc = CorpusScanner(corpus, metric="levenshtein", mesh=mesh,
                           bucket=32, weights=w)
        d = sc.distances("kitten")
        for s, g in zip(corpus, d):
            assert g == lev.distance("kitten", s, weights=w), (w, s, g)


def test_corpus_scanner_long_strings(mesh):
    """A 2048-char bucket on the XLA route."""
    rng = np.random.default_rng(5)
    long1 = "".join(chr(97 + c) for c in rng.integers(0, 4, 1500))
    long2 = long1[:700] + "x" * 5 + long1[705:]
    corpus = [long1, long2, "short", ""]
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=mesh)
    d = sc.distances(long1)
    assert d[0] == 0 and d[1] == lev.distance(long1, long2)
    assert d[2] == lev.distance(long1, "short") and d[3] == 1500


def test_scan_many_checkpoint_resume(mesh, tmp_path):
    corpus = ["apple", "apply", "ape", "maple", "orange", "grape"]
    queries = ["apple", "grape", "banana", "app", "orange", "pear"]
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=mesh, bucket=32)
    full = sc.scan_many(queries)
    for qi, q in enumerate(queries):
        np.testing.assert_array_equal(full[qi], sc.distances(q))

    ck = str(tmp_path / "scan.ck")
    partial = sc.scan_many(queries, checkpoint_path=ck, checkpoint_every=2)
    np.testing.assert_array_equal(partial, full)
    # resume: the completed checkpoint short-circuits recomputation
    resumed = sc.scan_many(queries, checkpoint_path=ck, checkpoint_every=2)
    np.testing.assert_array_equal(resumed, full)

    # genuine mid-run resume: poison the first two completed rows in a
    # hand-written checkpoint; a resumed run must keep them (proof it
    # resumes rather than recomputes) and fill the rest correctly
    poisoned = full.copy()
    poisoned[:2] = 123.0
    np.savez(ck + ".tmp.npz", n=sc.n, nq=len(queries), k=0, done=2,
             vals=poisoned, ids=np.empty(0),
             fp=sc._ckpt_fingerprint(queries))
    import os as _os
    _os.replace(ck + ".tmp.npz", ck)
    resumed2 = sc.scan_many(queries, checkpoint_path=ck, checkpoint_every=2)
    np.testing.assert_array_equal(resumed2[:2], poisoned[:2])
    np.testing.assert_array_equal(resumed2[2:], full[2:])

    # a checkpoint for DIFFERENT queries of the same shape must be
    # rejected (content fingerprint), not silently spliced in
    other = ["maple", "pear", "apple", "app", "orange", "banana"]
    recomputed = sc.scan_many(other, checkpoint_path=ck, checkpoint_every=2)
    for qi, q in enumerate(other):
        np.testing.assert_array_equal(recomputed[qi], sc.distances(q))

    # top-k variant
    vals, ids = sc.scan_many(queries, k=2)
    v0, i0 = sc.topk(queries[0], 2)
    np.testing.assert_array_equal(vals[0], v0)
    np.testing.assert_array_equal(ids[0], i0)


def test_scan_many_grouped_multiquery(kernel_route):
    """scan_many's grouped multi-query dispatch (``_distances_many``):
    uniform-Levenshtein kernel scans batch NQ_GROUP queries per launch,
    grouped by word bucket and PM mode, padded by repeating the last
    query.  Results must equal the per-query path for mixed-length query
    streams (W=1 and W=2 buckets, an empty query, chars forcing byte
    mode), and the k variant must match topk."""
    from jax.sharding import Mesh

    m1 = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    rng = np.random.default_rng(11)
    corpus = ["".join(chr(97 + c) for c in rng.integers(0, 26, n))
              for n in rng.integers(0, 30, 40)] + ["kitten", ""]
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=m1, bucket=32)
    assert sc._kernel and sc._nq_eligible()
    queries = (["kitten", "", "sitting", chr(200) * 3, "a" * 40, "b" * 35]
               + ["".join(chr(97 + c) for c in rng.integers(0, 26, 7))
                  for _ in range(7)])   # 13 queries: pads a partial group
    got = sc.scan_many(queries)
    for qi, q in enumerate(queries):
        np.testing.assert_array_equal(got[qi], sc.distances(q)), qi

    vals, ids = sc.scan_many(queries, k=3)
    for qi in (0, 3, 4):
        v0, i0 = sc.topk(queries[qi], 3)
        np.testing.assert_array_equal(vals[qi], v0)
        np.testing.assert_array_equal(ids[qi], i0)


def test_pallas_single_device_routing(kernel_route):
    """Single-device routing as on a GPU: the kernel route (levenshtein,
    indel), the XLA routes (osa, jaro, weighted), and the cutoff mask."""
    from jax.sharding import Mesh
    from rapidfuzz_tpu.distance import (indel as indel_mod, jaro as jaro_mod,
                                        osa as osa_mod)
    from rapidfuzz_tpu.distance.levenshtein import WeightTable

    m1 = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    corpus = ["sitting", "mitten", "kitchen", "apple", ""]
    for metric, mod in [("levenshtein", lev), ("osa", osa_mod),
                        ("indel", indel_mod), ("jaro", jaro_mod)]:
        sc = CorpusScanner(corpus, metric=metric, mesh=m1, bucket=32)
        assert sc._kernel == (metric in ("levenshtein", "indel"))
        assert sc._ndev == 1
        d = sc.distances("kitten")
        for s, g in zip(corpus, d):
            assert g == mod.distance("kitten", s), (metric, s)
    # weighted route (XLA Wagner-Fischer) + cutoff mask
    w = WeightTable(1, 2, 3)
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=m1, bucket=32,
                       weights=w)
    d = sc.distances("kitten")
    for s, g in zip(corpus, d):
        assert g == lev.distance("kitten", s, weights=w), s
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=m1, bucket=32)
    res = sc.distances("kitten", score_cutoff=2)
    assert res.tolist() == [lev.distance("kitten", s, score_cutoff=2)
                            for s in corpus]


def test_damerau_pallas_routing():
    """Damerau through the scanner's XLA route, including a unicode
    corpus."""
    from jax.sharding import Mesh
    from rapidfuzz_tpu.distance import damerau_levenshtein as dam

    m1 = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    corpus = ["abaa", "baaa", "CA", "", "Петрунко", "kitten", "ktiten"]
    sc = CorpusScanner(corpus, metric="damerau_levenshtein", mesh=m1,
                       bucket=32)
    assert not sc._kernel
    for query in ["aaaa", "AC", "Иванко", "kitten"]:
        d = sc.distances(query)
        for s, g in zip(corpus, d):
            assert g == dam.distance(query, s), (query, s, g)
    vals, ids = sc.topk("kitten", k=2)
    assert corpus[ids[0]] == "kitten" and vals[0] == 0
    assert corpus[ids[1]] == "ktiten" and vals[1] == 1   # transposition


def test_pallas_mesh_composition(mesh, kernel_route):
    """The scan kernel under shard_map over the 8-device mesh (the
    interpreter stands in for several GPUs); jaro rides the XLA route."""
    rng = np.random.default_rng(2)
    corpus = ["".join(chr(97 + c) for c in rng.integers(0, 26, int(l)))
              for l in rng.integers(1, 30, 64)]
    corpus += ["kitten", ""]
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=mesh, bucket=32)
    assert sc._kernel and sc._ndev == 8
    d = sc.distances("kitten")
    for i in list(range(0, len(corpus), 7)) + [len(corpus) - 2,
                                               len(corpus) - 1]:
        assert d[i] == lev.distance("kitten", corpus[i]), (i, corpus[i])
    vals, ids = sc.topk("kitten", k=2)
    assert corpus[ids[0]] == "kitten" and vals[0] == 0

    sc2 = CorpusScanner(corpus, metric="indel", mesh=mesh, bucket=32)
    from rapidfuzz_tpu.distance import indel as indel_mod
    d2 = sc2.distances("kitten")
    for i in range(0, len(corpus), 9):
        assert d2[i] == indel_mod.distance("kitten", corpus[i])

    from rapidfuzz_tpu.distance import jaro as jaro_mod
    sc3 = CorpusScanner(corpus, metric="jaro", mesh=mesh, bucket=32)
    d3 = sc3.distances("kitten")
    for i in range(0, len(corpus), 11):
        assert d3[i] == jaro_mod.distance("kitten", corpus[i]), (i, corpus[i])


def test_multihost_single_process(mesh):
    """The multi-host runner degenerates to a single-process sharded scan
    on the virtual mesh (the real 2-host config shares this code path)."""
    from rapidfuzz_tpu.parallel.multihost import global_scan_bench

    stats = global_scan_bench(corpus_size=1024, length=16, iters=2)
    assert stats["hosts"] == 1 and stats["devices"] == 8
    assert stats["corpus"] == 1024
    assert stats["pairs_per_s"] > 0


def test_extract():
    choices = ["kitten", "sitting", "mitten", "bitten", "xyz"]
    res = extract("kitten", choices, limit=3)
    assert res[0][0] == "kitten" and res[0][1] == pytest.approx(1.0)
    assert res[1][0] in ("mitten", "bitten")
    one = extract_one("kitten", choices)
    assert one[0] == "kitten"
    none = extract_one("kitten", ["xyz"], score_cutoff=0.9)
    assert none is None


def test_cdist():
    qs = ["abc", "xyz"]
    cs = ["abc", "abd", "zzz"]
    r = cdist(qs, cs, scorer="levenshtein", score_kind="distance")
    np.testing.assert_array_equal(r.values, [[0, 1, 3], [3, 3, 2]])
    r2 = cdist(qs, cs, scorer="jaro")
    assert r2.values[0, 0] == 1.0


def test_cdist_scanner_path_matches_scalar():
    """The CorpusScanner-backed many-vs-many path must agree with the
    scalar API for every score kind and metric family."""
    from rapidfuzz_tpu.distance import (damerau_levenshtein, jaro_winkler,
                                        levenshtein)

    qs = ["kitten", "abc", ""]
    cs = ["sitting", "mitten", "abd", "", "kitten"]
    for sk in ("distance", "similarity", "normalized_distance",
               "normalized_similarity"):
        r = cdist(qs, cs, scorer="levenshtein", score_kind=sk)
        for i, q in enumerate(qs):
            for j, c in enumerate(cs):
                assert r.values[i, j] == pytest.approx(
                    getattr(levenshtein, sk)(q, c), abs=1e-12), (sk, q, c)
    r = cdist(qs, cs, scorer="jaro_winkler")
    for i, q in enumerate(qs):
        for j, c in enumerate(cs):
            assert r.values[i, j] == jaro_winkler.similarity(q, c)
    r = cdist(qs, cs, scorer="damerau_levenshtein", score_kind="distance")
    for i, q in enumerate(qs):
        for j, c in enumerate(cs):
            assert r.values[i, j] == damerau_levenshtein.distance(q, c)


def test_wide_alphabet_pallas_routing(kernel_route):
    """Unicode (chars >= 256) corpora take the XLA route even on a GPU
    mesh (the reference keeps wide alphabets first-class via PM overflow
    hashmaps, ``pattern_match_vector.rs:104-155``) — single device and
    8-device mesh, every metric the kernel would otherwise serve."""
    from jax.sharding import Mesh
    from rapidfuzz_tpu.distance import (indel as indel_mod, jaro as jaro_mod,
                                        osa as osa_mod)

    rng = np.random.default_rng(7)
    # Cyrillic + CJK + ASCII mixed corpus
    pools = [(0x410, 0x44F), (0x4E00, 0x4E80), (97, 122)]
    corpus = []
    for i in range(30):
        lo, hi = pools[i % 3]
        corpus.append("".join(chr(c) for c in
                              rng.integers(lo, hi, rng.integers(1, 28))))
    corpus += ["Иванко", "Петрунко", "kitten", ""]
    m1 = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    for metric, mod in [("levenshtein", lev), ("osa", osa_mod),
                        ("indel", indel_mod), ("jaro", jaro_mod)]:
        sc = CorpusScanner(corpus, metric=metric, mesh=m1, bucket=32)
        assert not sc._kernel, metric
        for query in ["Иванко", "kitten", "不丁丙", ""]:
            d = sc.distances(query)
            for i in range(0, len(corpus), 5):
                assert d[i] == mod.distance(query, corpus[i]), \
                    (metric, query, corpus[i])

    # 8-device mesh route
    mesh8 = Mesh(np.array(jax.devices("cpu")[:8]), ("data",))
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=mesh8, bucket=32)
    assert not sc._kernel and sc._ndev == 8
    d = sc.distances("Иванко")
    for i in range(len(corpus)):
        assert d[i] == lev.distance("Иванко", corpus[i]), corpus[i]

    # a query with > 127 distinct symbols
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=m1, bucket=32)
    big_q = "".join(chr(0x410 + (i % 64)) + chr(0x4E00 + i) for i in range(80))
    d = sc.distances(big_q)
    for i in range(0, len(corpus), 7):
        assert d[i] == lev.distance(big_q, corpus[i]), corpus[i]

    # weighted route
    from rapidfuzz_tpu.distance.levenshtein import WeightTable
    w = WeightTable(1, 2, 3)
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=m1, bucket=32,
                       weights=w)
    d = sc.distances("Иванко")
    for i in range(0, len(corpus), 5):
        assert d[i] == lev.distance("Иванко", corpus[i], weights=w)


def test_stream_scanner_routing():
    """A 2048-char bucket (levenshtein, indel, osa, lcs_seq) on the XLA
    route, single device and 8-device mesh."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(11)
    base = "".join(chr(97 + c) for c in rng.integers(0, 26, 1200))
    corpus = [base,
              base[:600] + "xyz" + base[603:],
              base[:300] + base[310:],        # 10-char deletion
              "short", ""]
    m1 = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=m1)
    assert sc._LB == 2048
    q = base[:64]        # typical use: short query, long candidates
    d = sc.distances(q)
    for s, g in zip(corpus, d):
        assert g == lev.distance(q, s), (s[:20], g)

    # indel on the same bucket
    from rapidfuzz_tpu.distance import indel as indel_mod
    sc2 = CorpusScanner(corpus, metric="indel", mesh=m1)
    d2 = sc2.distances(q)
    for s, g in zip(corpus, d2):
        assert g == indel_mod.distance(q, s), (s[:20], g)

    # OSA on the same bucket
    from rapidfuzz_tpu.distance import osa as osa_mod
    swapped = base[:700] + base[701] + base[700] + base[702:]
    sc_osa = CorpusScanner(corpus + [swapped], metric="osa", mesh=m1)
    d_osa = sc_osa.distances(q)
    for s, g in zip(corpus + [swapped], d_osa):
        assert g == osa_mod.distance(q, s), (s[:20], g)

    # and over the 8-device mesh
    mesh8 = Mesh(np.array(jax.devices("cpu")[:8]), ("data",))
    sc3 = CorpusScanner(corpus, metric="lcs_seq", mesh=mesh8)
    assert sc3._ndev == 8
    from rapidfuzz_tpu.distance import lcs_seq as lcs_mod
    d3 = sc3.distances(q)
    for s, g in zip(corpus, d3):
        assert g == lcs_mod.distance(q, s), (s[:20], g)
    sc4 = CorpusScanner(corpus, metric="osa", mesh=mesh8)
    assert sc4._ndev == 8
    d4 = sc4.distances(q)
    for s, g in zip(corpus, d4):
        assert g == osa_mod.distance(q, s), (s[:20], g)


def test_jaro_stream_scanner_routing():
    """jaro/jaro_winkler on a 2048-char bucket (XLA route, host f64
    finish)."""
    from jax.sharding import Mesh
    from rapidfuzz_tpu.distance import jaro as jaro_mod
    from rapidfuzz_tpu.distance import jaro_winkler as jw_mod

    rng = np.random.default_rng(23)
    base = "".join(chr(97 + c) for c in rng.integers(0, 8, 1400))
    corpus = [base, base[:700] + base[701] + base[700] + base[702:],
              base[:1100], "short", ""]
    q = base[:48]
    for metric, mod in [("jaro", jaro_mod), ("jaro_winkler", jw_mod)]:
        m1 = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
        sc = CorpusScanner(corpus, metric=metric, mesh=m1)
        assert sc._LB == 2048
        d = sc.distances(q)
        for s, g in zip(corpus, d):
            assert abs(g - mod.distance(q, s)) < 1e-12, (metric, s[:20])
    # sharded form over the 8-device mesh
    mesh8 = Mesh(np.array(jax.devices("cpu")[:8]), ("data",))
    sc8 = CorpusScanner(corpus, metric="jaro", mesh=mesh8)
    assert sc8._ndev == 8
    d8 = sc8.distances(q)
    for s, g in zip(corpus, d8):
        assert abs(g - jaro_mod.distance(q, s)) < 1e-12, s[:20]


def test_wlev_stream_scanner_routing():
    """Weighted Levenshtein on a 2048-char bucket (XLA Wagner-Fischer),
    short and 300-char queries, single device and 8-device mesh."""
    from jax.sharding import Mesh
    from rapidfuzz_tpu.distance.levenshtein import WeightTable

    rng = np.random.default_rng(29)
    base = "".join(chr(97 + c) for c in rng.integers(0, 10, 1200))
    corpus = [base, base[:600] + "zz" + base[602:], base[:200], "ab", ""]
    w = WeightTable(2, 3, 5)
    m1 = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=m1, weights=w)
    q = base[:40]
    d = sc.distances(q)
    for s, g in zip(corpus, d):
        assert g == lev.distance(q, s, weights=w), (s[:20], g)
    # a 300-char query
    q2 = base[:300]
    d2 = sc.distances(q2)
    for s, g in zip(corpus, d2):
        assert g == lev.distance(q2, s, weights=w), (s[:20], g)
    # sharded form
    mesh8 = Mesh(np.array(jax.devices("cpu")[:8]), ("data",))
    sc8 = CorpusScanner(corpus, metric="levenshtein", mesh=mesh8,
                        weights=w)
    assert sc8._ndev == 8
    d8 = sc8.distances(q)
    for s, g in zip(corpus, d8):
        assert g == lev.distance(q, s, weights=w), (s[:20], g)


def test_hint_ladder_scan(kernel_route):
    """score_hint never changes results (hint contract,
    ``levenshtein.rs:2153-2160``), on the kernel route."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(31)
    q = "".join(chr(97 + c) for c in rng.integers(0, 6, 64))
    corpus = []
    for _ in range(600):            # mostly near the query (inside hint)
        s = list(q)
        for _ in range(int(rng.integers(0, 5))):
            s[rng.integers(0, 64)] = chr(97 + rng.integers(0, 6))
        corpus.append("".join(s))
    for _ in range(100):            # far beyond any hint (stragglers)
        corpus.append("".join(chr(110 + c)
                              for c in rng.integers(0, 6,
                                                    rng.integers(10, 90))))
    corpus += ["", q]
    m1 = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=m1)
    base = sc.distances(q)
    for hint in (4, 15, 31, 200, 0):
        got = sc.distances(q, score_hint=hint)
        np.testing.assert_array_equal(got, base), hint
    # hint composes with an explicit cutoff path untouched
    res = sc.distances(q, score_cutoff=3, score_hint=5)
    exp = sc.distances(q, score_cutoff=3)
    np.testing.assert_array_equal(res.values[res.valid],
                                  exp.values[exp.valid])


def test_multihost_two_process_cpu():
    """REAL 2-process jax.distributed run (CPU backend, gloo collectives):
    each process holds only its corpus shard; the planted exact match
    lives on process 0 only, so both processes reporting top1 == 0 proves
    the cross-process top-k merge (BASELINE's 2-host config, validated
    without accelerator hardware)."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    port = 19600 + (os.getpid() % 200)
    args = [sys.executable, "-m", "rapidfuzz_tpu.parallel.multihost",
            f"--coordinator=127.0.0.1:{port}", "--num-processes=2",
            "--corpus-size=16384", "--iters=2", "--platform", "cpu"]
    p1 = subprocess.Popen(args + ["--process-id=1"], env=env,
                          stdout=subprocess.PIPE, text=True)
    try:
        p0 = subprocess.run(args + ["--process-id=0"], env=env,
                            capture_output=True, text=True, timeout=240)
        out1, _ = p1.communicate(timeout=240)
    finally:
        p1.kill()
    s0 = json.loads([l for l in p0.stdout.splitlines()
                     if l.startswith("{")][-1])
    s1 = json.loads([l for l in out1.splitlines() if l.startswith("{")][-1])
    for s in (s0, s1):
        assert s["hosts"] == 2 and s["devices"] == 8
        assert s["top1"] == 0.0          # planted match, found across DCN
        assert s["corpus"] == 16384


def test_topk_kernel_route(kernel_route):
    """topk on the kernel route equals the deterministic full-scan top-k,
    for near matches and when every candidate is far away."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(33)
    q = "".join(chr(97 + c) for c in rng.integers(0, 6, 64))
    near = []
    for _ in range(40):
        s = list(q)
        for _ in range(int(rng.integers(0, 6))):
            s[rng.integers(0, 64)] = chr(97 + rng.integers(0, 6))
        near.append("".join(s))
    far = ["".join(chr(110 + c) for c in rng.integers(0, 6, 64))
           for _ in range(30)]
    m1 = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))

    sc = CorpusScanner(near + far, metric="levenshtein", mesh=m1)
    assert sc._kernel
    vals, ids = sc.topk(q, k=5)
    d_all = sc.distances(q)
    exp_ids = sc._topk_host(np.asarray(d_all, np.float64), 5)
    np.testing.assert_array_equal(ids, exp_ids)
    np.testing.assert_array_equal(vals, np.asarray(d_all)[ids])

    sc2 = CorpusScanner(far, metric="levenshtein", mesh=m1)
    vals2, ids2 = sc2.topk(q, k=5)
    d2 = sc2.distances(q)
    exp2 = sc2._topk_host(np.asarray(d2, np.float64), 5)
    np.testing.assert_array_equal(ids2, exp2)
    np.testing.assert_array_equal(vals2, np.asarray(d2)[ids2])


def test_damerau_long_scanner():
    """Damerau on a 384-char bucket (XLA route)."""
    from jax.sharding import Mesh
    from rapidfuzz_tpu.distance import damerau_levenshtein as dl

    rng = np.random.default_rng(43)
    base = "".join(chr(97 + c) for c in rng.integers(0, 6, 300))
    swapped = base[:150] + base[151] + base[150] + base[152:]
    corpus = [base, swapped, base[:40], "", base[:299] + "z"]
    m1 = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    sc = CorpusScanner(corpus, metric="damerau_levenshtein", mesh=m1)
    q = base[:64]
    d = sc.distances(q)
    for s, g in zip(corpus, d):
        assert g == dl.distance(q, s), (s[:20], g)
    vals, ids = sc.topk(q, k=2)
    assert corpus[ids[0]] == base[:64] or vals[0] == dl.distance(
        q, corpus[ids[0]])


def test_damerau_sharded_mesh(mesh):
    """Damerau on the 8-device mesh (short and long buckets, rows sharded
    over the data axis)."""
    from rapidfuzz_tpu.distance import damerau_levenshtein as dl

    rng = np.random.default_rng(47)
    corpus = ["abcd", "abdc", "xxxx", "ab", "", "badc"] * 50
    sc = CorpusScanner(corpus, metric="damerau_levenshtein", mesh=mesh,
                       bucket=32)
    assert sc._ndev == 8
    d = sc.distances("abcd")
    for s, g in zip(corpus, d):
        assert g == dl.distance("abcd", s), (s, g)

    base = "".join(chr(97 + c) for c in rng.integers(0, 6, 200))
    swapped = base[:90] + base[91] + base[90] + base[92:]
    corpus2 = [base, swapped, base[:10], ""] * 4
    sc2 = CorpusScanner(corpus2, metric="damerau_levenshtein", mesh=mesh)
    assert sc2._ndev == 8
    q = base[:48]
    d2 = sc2.distances(q)
    for s, g in zip(corpus2, d2):
        assert g == dl.distance(q, s), (s[:20], g)


def test_cdist_grouped_dispatches(mesh, kernel_route):
    """cdist with several queries rides scan_many's grouped multi-query
    dispatches and matches the per-query scan exactly; metrics off the
    kernel route scan one query at a time."""
    from jax.sharding import Mesh

    corpus = ["apple", "apply", "ape", "maple", "orange", "grape", ""] * 8
    queries = ["apple", "grape", "", "zzz"]
    m1 = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    # route through a single-device scanner (the grouped kernel path)
    from rapidfuzz_tpu.models import process as proc
    from rapidfuzz_tpu.parallel.scan import CorpusScanner
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=m1)
    got = proc._scanner_scores("levenshtein", queries, corpus,
                               "distance", scanner=sc)
    for qi, q in enumerate(queries):
        exp = [lev.distance(q, s) for s in corpus]
        np.testing.assert_array_equal(got[qi], exp), q

    # indel / lcs_seq ride the grouped LCS kernel (sim -> distance
    # finish); a 33-char query forces a second W group
    from rapidfuzz_tpu.distance import indel as indel_mod
    from rapidfuzz_tpu.distance import lcs_seq as lcs_mod
    queries2 = queries + ["a" * 33]
    for metric, mod in [("indel", indel_mod), ("lcs_seq", lcs_mod)]:
        sc = CorpusScanner(corpus, metric=metric, mesh=m1)
        assert sc._nq_eligible()
        got = np.asarray(sc.scan_many(queries2))
        for qi, q in enumerate(queries2):
            exp = [mod.distance(q, s) for s in corpus]
            np.testing.assert_array_equal(got[qi], exp), (metric, q)

    # osa / jaro / jaro_winkler: XLA route, one query per scan
    from rapidfuzz_tpu.distance import jaro as jaro_mod
    from rapidfuzz_tpu.distance import jaro_winkler as jw_mod
    from rapidfuzz_tpu.distance import osa as osa_mod
    sc = CorpusScanner(corpus, metric="osa", mesh=m1)
    assert not sc._nq_eligible()
    got = np.asarray(sc.scan_many(queries))
    for qi, q in enumerate(queries):
        exp = [osa_mod.distance(q, s) for s in corpus]
        np.testing.assert_array_equal(got[qi], exp), q
    for metric, mod in [("jaro", jaro_mod), ("jaro_winkler", jw_mod)]:
        sc = CorpusScanner(corpus, metric=metric, mesh=m1)
        assert not sc._nq_eligible()
        got = np.asarray(sc.scan_many(queries))
        for qi, q in enumerate(queries):
            exp = np.array([1.0 - mod.similarity(q, s) for s in corpus])
            assert np.abs(got[qi] - exp).max() < 1e-12, (metric, q)


def test_partial_ratio_scanner_routing():
    """CorpusScanner(metric="partial_ratio"): the host window sweep
    (cutoff masking, long and empty queries), a wide alphabet and an
    8-device mesh all reproduce scalar ``fuzz.partial_ratio`` exactly
    (distance = 1 - best-window ratio)."""
    from jax.sharding import Mesh
    from rapidfuzz_tpu import fuzz
    from rapidfuzz_tpu.parallel.scan import CorpusScanner

    rng = np.random.default_rng(21)
    letters = list("abcdefg")
    corpus = ["".join(rng.choice(letters, int(n)))
              for n in rng.integers(0, 40, 120)] + ["", "needle here"]
    q = "needle"
    exp = np.array([fuzz.partial_ratio(q, c) for c in corpus])

    # host window sweep (+ cutoff masking in distance space)
    sc = CorpusScanner(corpus, metric="partial_ratio")
    d = sc.distances(q)
    np.testing.assert_array_equal(1.0 - d, exp)
    r = sc.distances(q, score_cutoff=0.25)
    assert (r.valid == (d <= 0.25)).all()
    # an 80-char query
    lq = "".join(rng.choice(letters, 80))
    exp_l = np.array([fuzz.partial_ratio(lq, c) for c in corpus])
    assert np.abs((1.0 - sc.distances(lq)) - exp_l).max() < 1e-12
    # empty query
    np.testing.assert_array_equal(
        1.0 - sc.distances(""),
        [1.0 if len(c) == 0 else 0.0 for c in corpus])

    # wide alphabet
    wide = ["".join(chr(c) for c in rng.integers(0x410, 0x44F,
                                                 rng.integers(1, 25)))
            for _ in range(40)] + ["Иванко", ""]
    wq = "Петрунко"
    exp_w = np.array([fuzz.partial_ratio(wq, c) for c in wide])
    sc_w = CorpusScanner(wide, metric="partial_ratio")
    np.testing.assert_array_equal(1.0 - sc_w.distances(wq), exp_w)

    # 8-device mesh
    mesh8 = Mesh(np.array(jax.devices("cpu")), ("data",))
    sc_m = CorpusScanner(corpus, metric="partial_ratio", mesh=mesh8)
    np.testing.assert_array_equal(1.0 - sc_m.distances(q), exp)

    # process integration: extract over the scanner metric
    from rapidfuzz_tpu.models import extract
    hits = extract(q, corpus, scorer="partial_ratio", limit=3)
    assert hits[0][1] == exp.max()


def test_banded_stream_scanner():
    """score_cutoff masks exactly on a long (1536-char) bucket: values
    under the cutoff are exact, the rest invalid."""
    rng = np.random.default_rng(23)
    letters = list("abcdef")
    q = "".join(rng.choice(letters, 200))
    corpus = []
    for i in range(48):
        k = i % 3
        if k == 0:          # near-misses (results under the cutoff)
            c = list(q)
            for _ in range(int(rng.integers(0, 25))):
                c[int(rng.integers(len(c)))] = rng.choice(letters)
            corpus.append("".join(c))
        elif k == 1:        # far candidates, arbitrary lengths
            corpus.append("".join(rng.choice(
                letters, int(rng.integers(0, 1400)))))
        else:               # query + suffix
            corpus.append(q + "".join(rng.choice(
                letters, int(rng.integers(0, 30)))))
    sc = CorpusScanner(corpus, metric="levenshtein", bucket=1536)
    exp = np.array([lev.distance(q, c) for c in corpus])
    for cutoff in (9, 20, 47):
        r = sc.distances(q, score_cutoff=cutoff)
        under = exp <= cutoff
        np.testing.assert_array_equal(r.valid, under, err_msg=str(cutoff))
        np.testing.assert_array_equal(r.values[under], exp[under])


def test_banded_stream_sharded(mesh):
    """The cutoff mask on a long bucket over the 8-device mesh."""
    rng = np.random.default_rng(29)
    letters = list("abcd")
    q = "".join(rng.choice(letters, 180))
    corpus = []
    for i in range(32):
        if i % 2:
            c = list(q)
            for _ in range(int(rng.integers(0, 12))):
                c[int(rng.integers(len(c)))] = rng.choice(letters)
            corpus.append("".join(c))
        else:
            corpus.append("".join(rng.choice(
                letters, int(rng.integers(0, 1200)))))
    exp = np.array([lev.distance(q, c) for c in corpus])
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=mesh,
                       bucket=1536)
    r = sc.distances(q, score_cutoff=10)
    under = exp <= 10
    np.testing.assert_array_equal(r.valid, under)
    np.testing.assert_array_equal(r.values[under], exp[under])


def test_hint_ladder_stream():
    """score_hint on a long (1536-char) bucket: results identical for any
    hint (the levenshtein.rs:2153-2160 contract)."""
    rng = np.random.default_rng(43)
    letters = list("abcd")
    q = "".join(rng.choice(letters, 180))
    corpus = []
    for i in range(24):
        if i % 2:
            c = list(q)
            for _ in range(int(rng.integers(0, 12))):
                c[int(rng.integers(len(c)))] = rng.choice(letters)
            corpus.append("".join(c))
        else:
            corpus.append("".join(rng.choice(
                letters, int(rng.integers(0, 1200)))))
    exp = np.array([lev.distance(q, c) for c in corpus])
    sc = CorpusScanner(corpus, metric="levenshtein", bucket=1536)
    for hint in (5, 40, 10 ** 6):
        np.testing.assert_array_equal(sc.distances(q, score_hint=hint),
                                      exp, err_msg=str(hint))


def test_bucketed_scanner(kernel_route):
    """BucketedScanner splits heterogeneous corpora into length classes
    (one device scanner each) and merges results in corpus order;
    distances/topk/scan_many match the flat scanner exactly, incl. the
    deterministic top-k tie-break."""
    from rapidfuzz_tpu.parallel import BucketedScanner

    rng = np.random.default_rng(51)
    letters = list("abcdef")
    corpus = ([
        "".join(rng.choice(letters, int(n)))
        for n in rng.integers(0, 30, 100)]
        + ["".join(rng.choice(letters, int(n)))
           for n in rng.integers(100, 250, 30)] + [""])
    q = "".join(rng.choice(letters, 24))
    exp = np.array([lev.distance(q, c) for c in corpus])
    bs = BucketedScanner(corpus, metric="levenshtein", min_split=16)
    assert len(bs.classes) == 2
    np.testing.assert_array_equal(bs.distances(q), exp)
    r = bs.distances(q, score_cutoff=20)
    assert (r.valid == (exp <= 20)).all()
    flat = CorpusScanner(corpus, metric="levenshtein")
    v1, i1 = bs.topk(q, 7)
    v2, i2 = flat.topk(q, 7)
    np.testing.assert_array_equal(v1, np.asarray(v2, np.float64))
    np.testing.assert_array_equal(i1, i2)
    qs = [q, "", "abcdef"]
    v, i = bs.scan_many(qs, k=5)
    for qi, qq in enumerate(qs):
        fv, fi = flat.topk(qq, 5)
        np.testing.assert_array_equal(v[qi][:len(fv)],
                                      np.asarray(fv, np.float64))
        np.testing.assert_array_equal(i[qi][:len(fi)], fi)
    # homogeneous corpus collapses to one child
    assert len(BucketedScanner(["abc"] * 50, min_split=16).classes) == 1


def test_topk_empty_and_small_corpus(monkeypatch):
    """k clamps to the corpus size: empty corpora return empty results
    (regression: padding rows surfaced as int64-min garbage), and n < k
    returns exactly n entries on every route."""
    sc = CorpusScanner([], metric="levenshtein")
    v, i = sc.topk("abc", 3)
    assert v.size == 0 and i.size == 0
    assert sc.distances("abc").size == 0
    sc2 = CorpusScanner(["ab"], metric="levenshtein")
    v, i = sc2.topk("abc", 3)
    assert list(i) == [0] and v[0] == lev.distance("abc", "ab")
    from rapidfuzz_tpu.ops import route, scan_kernel
    monkeypatch.setattr(route, "mesh_platform", lambda mesh: "gpu")
    monkeypatch.setattr(scan_kernel, "INTERPRET", True)
    sc3 = CorpusScanner(["ab"], metric="levenshtein")
    assert sc3._kernel
    v, i = sc3.topk("abc", 3)
    assert list(i) == [0] and v[0] == lev.distance("abc", "ab")
    from rapidfuzz_tpu.parallel import BucketedScanner
    bs = BucketedScanner([], metric="levenshtein")
    v, i = bs.topk("abc", 3)
    assert v.size == 0 and bs.distances("abc").size == 0
