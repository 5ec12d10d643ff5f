"""Route choice (``ops/route.py``), the chunked XLA route
(``ops/dispatch.chunked``) and the scanner's kernel route on the CPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from rapidfuzz_tpu.distance import indel, lcs_seq
from rapidfuzz_tpu.distance import levenshtein as lev
from rapidfuzz_tpu.ops import dispatch
from rapidfuzz_tpu.ops import route
from rapidfuzz_tpu.parallel import CorpusScanner
from rapidfuzz_tpu.utils import codec


@pytest.mark.parametrize("platform,metric,bucket,kw,expect", [
    ("gpu", "levenshtein", 64, {}, (True, 1)),
    ("gpu", "indel", 128, {}, (True, 1)),
    ("gpu", "lcs_seq", route.KERNEL_MAX_LB, {}, (True, 1)),
    ("gpu", "levenshtein", 2 * route.KERNEL_MAX_LB, {}, (False, 1)),
    ("gpu", "levenshtein", 64, {"wide": True}, (False, 1)),
    ("gpu", "levenshtein", 64, {"weighted": True}, (False, 1)),
    ("gpu", "levenshtein", 64, {"words": route.KERNEL_MAX_WORDS + 1},
     (False, 1)),
    ("gpu", "osa", 64, {}, (False, 1)),
    ("gpu", "jaro", 64, {}, (False, 1)),
    ("gpu", "damerau_levenshtein", 64, {}, (False, 1)),
    ("cpu", "levenshtein", 64, {}, (False, 1)),
    ("cpu", "indel", 64, {"grouped": True}, (False, 1)),
    ("rocm", "levenshtein", 64, {}, (False, 1)),
    ("gpu", "levenshtein", 64, {"grouped": True, "words": 2}, (True, 4)),
    ("gpu", "indel", 64, {"grouped": True, "words": 4}, (True, 2)),
    ("gpu", "lcs_seq", 512, {"grouped": True, "words": 8}, (True, 1)),
])
def test_pick_route(platform, metric, bucket, kw, expect):
    assert tuple(route.pick_route(platform, metric, bucket, **kw)) == expect


def test_mesh_platform():
    devs = jax.devices("cpu")
    assert route.mesh_platform(Mesh(np.array(devs[:2]), ("data",))) == "cpu"


def _pairs(seed, n, la, lb, alphabet=4):
    rng = np.random.default_rng(seed)
    q = rng.integers(97, 97 + alphabet, la)
    lens = rng.integers(0, lb + 1, n).astype(np.int32)
    chars = rng.integers(97, 97 + alphabet, (n, lb)).astype(np.int32)
    chars[np.arange(lb)[None, :] >= lens[:, None]] = -1
    qc, ql = codec.pad_batch([q])
    return [jnp.asarray(x) for x in (qc, ql, chars, lens)]


@pytest.mark.parametrize("op", ["levenshtein", "lcs", "weighted", "jaro",
                                "damerau"])
def test_chunked_matches_whole_batch(monkeypatch, op):
    """A budget of a few rows splits the candidate axis into padded
    chunks (lax.map); every output equals the unchunked op, tuple outputs
    included."""
    from rapidfuzz_tpu.ops import damerau, jaro, lcs, levenshtein

    fn = {"levenshtein": levenshtein.uniform_distance,
          "lcs": lcs.lcs_similarity,
          "weighted": lambda *a: levenshtein.weighted_distance(
              *a, ins=1, dele=2, sub=3),
          "jaro": jaro.jaro_components,
          "damerau": damerau.damerau_distance}[op]
    args = _pairs(5, 37, 40, 64)
    whole = fn(*args)
    monkeypatch.setattr(dispatch, "XLA_CHUNK_BYTES", 3 * 4 * 64 * 64)
    got = jax.jit(dispatch.chunked(fn))(*args)   # three rows per chunk
    for w, g in zip(jax.tree.leaves(whole), jax.tree.leaves(got)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_chunked_keeps_small_batches_whole(monkeypatch):
    calls = []

    def fn(a, la, b, lb):
        calls.append(b.shape)
        return lb
    args = _pairs(1, 8, 10, 32)
    dispatch.chunked(fn)(*args)
    assert calls == [(8, 32)]
    monkeypatch.setattr(dispatch, "XLA_CHUNK_BYTES", 4 * 32 * 32 * 3)
    dispatch.chunked(fn)(*args)
    assert calls[-1] == (3, 32)


@pytest.mark.parametrize("metric", ["levenshtein", "jaro", "osa"])
def test_scanner_xla_route_chunked(monkeypatch, mesh8, metric):
    """The scanner's XLA route under a tiny chunk budget (per shard of the
    8-device mesh) returns what an unchunked scanner does."""
    rng = np.random.default_rng(17)
    corpus = ["".join(chr(97 + c) for c in rng.integers(0, 5, int(n)))
              for n in rng.integers(0, 60, 90)]
    whole = CorpusScanner(corpus, metric=metric, mesh=mesh8)
    exp = whole.distances("abcdeabcde")
    monkeypatch.setattr(dispatch, "XLA_CHUNK_BYTES", 4 * 64 * 32 * 2)
    sc = CorpusScanner(corpus, metric=metric, mesh=mesh8)
    np.testing.assert_array_equal(sc.distances("abcdeabcde"), exp)


@pytest.fixture(scope="module")
def mesh8():
    return Mesh(np.array(jax.devices("cpu")[:8]), ("data",))


@pytest.mark.parametrize("metric,mod", [("levenshtein", lev),
                                        ("indel", indel),
                                        ("lcs_seq", lcs_seq)])
def test_scanner_kernel_route(kernel_route, mesh8, metric, mod):
    """On a (stand-in) GPU mesh the scanner takes the kernel route:
    length-sorted packed shards, unsorted results, padding rows masked
    out of top-k; distances, cutoff, topk and the grouped scan_many all
    equal the scalar API and the forced XLA route."""
    rng = np.random.default_rng(3)
    corpus = ["".join(chr(97 + c) for c in rng.integers(0, 6, int(n)))
              for n in rng.integers(0, 70, 150)] + ["kitten", ""]
    sc = CorpusScanner(corpus, metric=metric, mesh=mesh8)
    xla = CorpusScanner(corpus, metric=metric, mesh=mesh8, force_xla=True)
    assert sc._kernel and not xla._kernel and sc._xla_corpus is None
    assert sc.cand.shape[1] % (8 * 128) == 0
    queries = ["kitten", "", "abcdefabcdefabcdefabcdefabcdefabcdefab"]
    for q in queries:
        d = sc.distances(q)
        np.testing.assert_array_equal(d, xla.distances(q))
        for i in range(0, len(corpus), 13):
            assert d[i] == mod.distance(q, corpus[i]), (q, corpus[i])
        r = sc.distances(q, score_cutoff=5)
        assert r.tolist() == xla.distances(q, score_cutoff=5).tolist()
        v, ids = sc.topk(q, 4)
        vx, idx = xla.topk(q, 4)
        np.testing.assert_array_equal(v, vx)
        np.testing.assert_array_equal(ids, idx)
    np.testing.assert_array_equal(sc.scan_many(queries),
                                  xla.scan_many(queries))
    v, i = sc.scan_many(queries, k=3)
    for qi, q in enumerate(queries):
        tv, ti = xla.topk(q, 3)
        np.testing.assert_array_equal(v[qi], tv)
        np.testing.assert_array_equal(i[qi], ti)


def test_scanner_kernel_route_query_past_word_cap(kernel_route):
    """A query wider than the kernel's word cap scans on the XLA ops over
    the unpacked copy of the sorted corpus; grouped scans route it the
    same way."""
    rng = np.random.default_rng(4)
    corpus = ["".join(chr(97 + c) for c in rng.integers(0, 4, int(n)))
              for n in rng.integers(0, 64, 60)]
    m1 = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    sc = CorpusScanner(corpus, metric="levenshtein", mesh=m1)
    assert sc._kernel and sc._xla_corpus is None
    long_q = "abcd" * (8 * route.KERNEL_MAX_WORDS + 1)
    d = sc.distances(long_q)
    assert sc._xla_corpus is not None
    for i in range(0, len(corpus), 6):
        assert d[i] == lev.distance(long_q, corpus[i])
    many = sc.scan_many([long_q, "abc"])
    np.testing.assert_array_equal(many[0], d)
    np.testing.assert_array_equal(many[1], sc.distances("abc"))


def test_scanner_wide_alphabet_takes_xla(kernel_route):
    """Chars >= 256 take the XLA route even on a GPU mesh."""
    corpus = ["Иванко", "Петрунко", "kitten", ""]
    sc = CorpusScanner(corpus, metric="levenshtein")
    assert not sc._kernel
    np.testing.assert_array_equal(
        sc.distances("Иван"), [lev.distance("Иван", c) for c in corpus])
