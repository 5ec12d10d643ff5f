"""The Pallas scan kernel (``ops/scan_kernel.py``) against the XLA ops and
the C++ oracle: in Pallas' interpreter on the CPU, compiled on a GPU.

Every case shares one corpus shape (B = 256 candidates, bucket 128) so the
interpreter compiles few variants; candidate lengths cover the word
boundaries 0/31/32/33/63/64 and the bucket width.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rapidfuzz_tpu import oracle
from rapidfuzz_tpu.ops import lcs as lcs_ops
from rapidfuzz_tpu.ops import levenshtein as lev_ops
from rapidfuzz_tpu.ops import scan_kernel as sk
from rapidfuzz_tpu.utils import codec

B, LB = 256, 128
EDGE_LENS = (0, 1, 31, 32, 33, 63, 64, 65, 127, 128)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    if jax.devices()[0].platform != "gpu":
        monkeypatch.setattr(sk, "INTERPRET", True)


def _corpus(seed, lo, hi, lens=None, n=B, width=LB):
    """[n, width] chars drawn from [lo, hi) (PAD past each length)."""
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(0, width + 1, n)
        lens[: len(EDGE_LENS)] = EDGE_LENS
    lens = np.asarray(lens, np.int32)
    chars = rng.integers(lo, hi, (n, width)).astype(np.int32)
    chars[np.arange(width)[None, :] >= lens[:, None]] = -1
    return chars, lens


def _kernel(metric, queries, chars, lens, mode, group=1):
    cand = sk.prepare_corpus(jnp.asarray(chars), LB=chars.shape[1])
    return np.asarray(sk.scan(metric, queries, cand, jnp.asarray(lens),
                              mode=mode, group=group))


def _xla(metric, q, chars, lens):
    fn = lev_ops.uniform_distance if metric == "levenshtein" \
        else lcs_ops.lcs_similarity
    qc, ql = codec.pad_batch([np.asarray(q, np.int64)])
    return np.asarray(fn(jnp.asarray(qc), jnp.asarray(ql),
                         jnp.asarray(chars), jnp.asarray(lens)))


def _oracle(metric, q, chars, lens, rows):
    fn = oracle.levenshtein_uniform if metric == "levenshtein" \
        else oracle.lcs_seq
    return np.array([fn(np.asarray(q, np.int64),
                        chars[i, : lens[i]].astype(np.int64))
                     for i in rows])


@pytest.mark.parametrize("mode", ["local", "byte"])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("metric", ["levenshtein", "lcs"])
def test_kernel_matches_xla_and_oracle(metric, W, mode):
    """Every word count 1-4, both table sizes: all rows equal the XLA op,
    a sample of rows equals the oracle."""
    lo, hi = (97, 101) if mode == "local" else (0, 256)
    chars, lens = _corpus(W, lo, hi)
    la = 32 * W - 5
    q = np.random.default_rng(100 + W).integers(lo, hi, la)
    # plant near-copies so distances span small and large values
    for i in range(len(EDGE_LENS), B, 9):
        n = min(la, int(lens[i]))
        chars[i, :n] = q[:n]
    got = _kernel(metric, [q], chars, lens, mode)[0]
    np.testing.assert_array_equal(got, _xla(metric, q, chars, lens))
    rows = np.arange(0, B, 7)
    np.testing.assert_array_equal(got[rows],
                                  _oracle(metric, q, chars, lens, rows))


@pytest.mark.parametrize("case", ["empty", "one_char", "longer_than_all",
                                  "nul_chars"])
@pytest.mark.parametrize("metric", ["levenshtein", "lcs"])
def test_kernel_edge_queries(metric, case):
    """Empty and 1-char queries, a query longer than every candidate, and
    NUL chars (byte 0 is also the packed padding value)."""
    if case == "longer_than_all":
        chars, lens = _corpus(7, 97, 100, lens=np.arange(B) % 40)
        q = np.random.default_rng(7).integers(97, 100, 120)
        mode = "local"
    elif case == "nul_chars":
        chars, lens = _corpus(8, 0, 3)
        q = np.array([0, 0, 1, 0, 2, 0] * 6)
        mode = "byte"
    else:
        chars, lens = _corpus(9, 97, 100)
        q = np.array([] if case == "empty" else [98], np.int64)
        mode = "local"
    got = _kernel(metric, [q], chars, lens, mode)[0]
    rows = np.arange(B)
    np.testing.assert_array_equal(got, _oracle(metric, q, chars, lens, rows))


@pytest.mark.parametrize("length", [0, 31, 32, 33, 63, 64])
@pytest.mark.parametrize("metric", ["levenshtein", "lcs"])
def test_kernel_uniform_candidate_length(metric, length):
    """A block whose candidates all share one length: the unmasked text
    loop covers it entirely (min == max length)."""
    chars, lens = _corpus(20 + length, 97, 103, lens=np.full(B, length))
    q = np.random.default_rng(length).integers(97, 103, 45)
    got = _kernel(metric, [q], chars, lens, "local")[0]
    rows = np.arange(0, B, 5)
    np.testing.assert_array_equal(got[rows],
                                  _oracle(metric, q, chars, lens, rows))


@pytest.mark.parametrize("metric", ["levenshtein", "lcs"])
def test_kernel_padding_rows(metric):
    """Length-0 padding rows: Levenshtein gives the query length, LCS 0."""
    chars, lens = _corpus(3, 97, 100)
    lens[B // 2:] = 0
    chars[B // 2:] = -1
    q = np.array([97, 98, 99, 97, 98])
    got = _kernel(metric, [q], chars, lens, "local")[0]
    assert (got[B // 2:] == (5 if metric == "levenshtein" else 0)).all()


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("metric", ["levenshtein", "lcs"])
def test_kernel_grouped(metric, group):
    """The grouped form (``group`` queries per program, one shared text
    load) equals one scan per query, empty query included."""
    chars, lens = _corpus(40, 97, 101)
    rng = np.random.default_rng(41)
    qs = [rng.integers(97, 101, n) for n in (20, 0, 1, 32)]
    got = _kernel(metric, qs, chars, lens, "local", group=group)
    for k, q in enumerate(qs):
        np.testing.assert_array_equal(got[k], _xla(metric, q, chars, lens))


def test_kernel_rejects_mixed_word_buckets():
    with pytest.raises(ValueError, match="word buckets"):
        sk.scan("lcs", [np.arange(3), np.arange(40)], None, None,
                mode="local")


def test_prepare_corpus_layout():
    """Char j of candidate b is byte j % 4 of word [j // 4, b]; padding
    packs as 0."""
    chars = np.array([[1, 2, 3, 4, 5, -1, -1, -1],
                      [9, 8, -1, -1, -1, -1, -1, -1]], np.int32)
    got = np.asarray(sk.prepare_corpus(jnp.asarray(chars), LB=8))
    assert got.shape == (2, 2) and got.dtype == np.uint32
    assert got[0, 0] == 1 | 2 << 8 | 3 << 16 | 4 << 24
    assert got[1, 0] == 5
    assert got[0, 1] == 9 | 8 << 8 and got[1, 1] == 0


def test_build_pm_table():
    """Bit i of row q[i] (word i // 32); duplicate chars OR together; out
    of range chars (never in a byte corpus) set nothing; the last row
    stays zero."""
    q = np.array([5, 7, 5] + [1] * 30 + [5, 300])
    t = sk.build_pm_table(q, 128, 2)
    assert t.shape == (129, 2) and t.dtype == np.uint32
    assert t[5, 0] == 0b101 and t[5, 1] == 1 << 1
    assert t[7, 0] == 0b10
    assert t[1, 0] == (0xFFFFFFFF << 3) & 0xFFFFFFFF and t[1, 1] == 1
    assert not t[128].any() and t.sum() == t[[1, 5, 7]].sum()


@pytest.mark.parametrize("query,cmax,mode", [
    ([97, 98], 122, "local"), ([97, 200], 122, "byte"),
    ([97], 255, "byte"), ([], 0, "local")])
def test_pick_mode(query, cmax, mode):
    assert sk.pick_mode(np.array(query), cmax) == mode
    assert sk.table_rows(mode) == (128 if mode == "local" else 256)


@pytest.mark.gpu
@pytest.mark.parametrize("LB_", [32, 64, 128])
@pytest.mark.parametrize("metric", ["levenshtein", "lcs"])
def test_kernel_compiled_on_gpu(gpu, metric, LB_):
    """The compiled kernel on the card, 64k candidates per bucket: every
    row equals the XLA op, a sample equals the oracle."""
    n = 1 << 16
    chars, lens = _corpus(LB_, 32, 127, lens=np.random.default_rng(LB_)
                          .integers(8, LB_ + 1, n), n=n, width=LB_)
    q = np.random.default_rng(LB_ + 1).integers(32, 127, LB_)
    got = _kernel(metric, [q], chars, lens, "local")[0]
    np.testing.assert_array_equal(got, _xla(metric, q, chars, lens))
    rows = np.arange(0, n, 97)
    np.testing.assert_array_equal(got[rows],
                                  _oracle(metric, q, chars, lens, rows))
