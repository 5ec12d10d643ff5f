"""``fuzz`` family.

``ratio`` is the reference crate's only fuzz scorer (``fuzz.rs:60-85``:
indel normalized similarity in ``[0.0, 1.0]``; ``fuzz.rs:207-213``
comments out the rest).  The remaining ecosystem scorers
(rapidfuzz-cpp/-py) are provided on top of it:

* ``partial_ratio`` — best sliding-window ``ratio`` of the shorter string
  against the longer, windows batched through the device LCS kernel
  (every window of the unbounded alignment, clipped to the string: the
  window set is ``longer[max(0, i-m) : min(n, i)]`` for ``i`` in
  ``1..n+m-1``, so overhanging edge alignments count like the
  ecosystem's).  Scores stay in ``[0.0, 1.0]``.
* ``token_sort_ratio`` / ``token_set_ratio`` / ``token_ratio`` and their
  ``partial_`` forms — whitespace tokenization on host, scoring on the
  same kernels.
* ``WRatio`` / ``QRatio`` — the standard weighted combinations.

Empty-input convention follows the crate's score algebra
(``maximum == 0 -> normalized similarity 1.0``): two empty inputs score
1.0; one empty input scores 0.0.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from . import common as _c
from . import oracle as _oracle
from .ops import dispatch as _dispatch
from .utils import codec as _codec


class Args(_c.ArgsBase):
    pass


def ratio(s1, s2, *, processor: Optional[Callable] = None,
          score_cutoff: Optional[float] = None,
          score_hint: Optional[float] = None) -> Optional[float]:
    """Indel-based normalized similarity in [0, 1] (``fuzz.rs:48-85``).

    >>> from rapidfuzz_tpu import fuzz
    >>> round(fuzz.ratio("this is a test", "this is a test!"), 4)
    0.9655
    >>> fuzz.ratio("this is a test", "this is a test!",
    ...            score_cutoff=0.99) is None
    True
    >>> fuzz.ratio("this is a test", "THIS is a TEST!",
    ...            processor=fuzz.default_process)
    1.0
    """
    if processor is not None:
        s1, s2 = processor(s1), processor(s2)
    if type(s1) in (str, bytes) and type(s2) in (str, bytes):
        fast = _oracle.fast_scalar()
        if fast is not None:            # in-process C one-shot path
            mx = len(s1) + len(s2)
            sim = 1.0 - _c.norm_dist_from_dist(
                fast.int_metric(0, s1, s2), mx)
            return _c.apply_similarity_cutoff(sim, score_cutoff)
    u1, u2 = _codec.encode_one(s1), _codec.encode_one(s2)
    mx = u1.size + u2.size
    dist = _oracle.indel(u1, u2)
    sim = 1.0 - _c.norm_dist_from_dist(dist, mx)
    return _c.apply_similarity_cutoff(sim, score_cutoff)


def ratio_with_args(s1, s2, args: Args):
    return ratio(s1, s2, score_cutoff=args.cutoff, score_hint=args.hint)


class RatioBatchComparator:
    """One-vs-many ``ratio`` (``fuzz.rs:98-150``)."""

    def __init__(self, s1):
        # keep str/bytes queries for the C one-shot route (the
        # reference's BatchComparator is its fastest scalar path)
        self._s1 = s1 if type(s1) in (str, bytes) else None
        self._u1 = _codec.encode_one(s1)

    def _q(self, s2):
        return (self._s1 if self._s1 is not None
                and type(s2) in (str, bytes) else self._u1)

    def similarity(self, s2, *, score_cutoff=None, score_hint=None):
        return ratio(self._q(s2), s2, score_cutoff=score_cutoff,
                     score_hint=score_hint)

    def similarity_with_args(self, s2, args: Args):
        return ratio(self._q(s2), s2, score_cutoff=args.cutoff,
                     score_hint=args.hint)

    def similarities(self, corpus, *, score_cutoff=None
                     ) -> _dispatch.BatchResult:
        nsim = _aligned_ratio([self._u1],
                              [_codec.encode_one(c) for c in corpus])
        return _dispatch.BatchResult(*_c.mask_similarity(nsim, score_cutoff))


# --------------------------------------------------------- ecosystem scorers

def default_process(s: str) -> str:
    """Standard preprocessor: non-alphanumeric runs -> space, lowercase,
    trim (the ecosystem's ``utils.default_process``).

    >>> from rapidfuzz_tpu import fuzz
    >>> fuzz.default_process("  The QUICK-brown fox! ")
    'the quick brown fox'
    """
    return re.sub(r"\W", " ", s, flags=re.UNICODE).lower().strip()


def _processed(s1, s2, processor: Optional[Callable]):
    if processor is None:
        return s1, s2
    return processor(s1), processor(s2)


@dataclass(frozen=True)
class ScoreAlignment:
    """Where the best ``partial_ratio`` window sits:
    ``ratio(s1[src_start:src_end], s2[dest_start:dest_end]) == score``."""
    score: float
    src_start: int
    src_end: int
    dest_start: int
    dest_end: int


def _best_window(us: np.ndarray, ul: np.ndarray):
    """(best_ratio, (start, end)) of the shorter ``us`` against every
    clipped window of the longer ``ul``, via the batched LCS kernel."""
    from .ops import lcs as _lcs_ops

    m, n = int(us.size), int(ul.size)
    if m == 0:
        return (1.0 if n == 0 else 0.0), (0, 0)
    starts = np.maximum(0, np.arange(1, n + m) - m)
    ends = np.minimum(n, np.arange(1, n + m))
    best = -1.0
    best_se = (0, 0)
    # chunk the window batch to bound host/device memory on long inputs
    chunk = max(256, (1 << 22) // max(m, 1))
    for lo in range(0, len(starts), chunk):
        ss, ee = starts[lo:lo + chunk], ends[lo:lo + chunk]
        wins = [ul[s:e] for s, e in zip(ss, ee)]
        c1, l1, c2, l2 = _codec.encode_pair_batch([us], wins, bucket2=None)
        sim = _dispatch.run_pairs(_lcs_ops.lcs_similarity, c1, l1, c2, l2)
        tot = m + l2.astype(np.int64)
        r = 1.0 - (tot - 2 * sim.astype(np.int64)) / np.maximum(tot, 1)
        k = int(np.argmax(r))
        if float(r[k]) > best:
            best = float(r[k])
            best_se = (int(ss[k]), int(ee[k]))
        if best >= 1.0:
            break
    return best, best_se


def partial_ratio_alignment(s1, s2, *, processor: Optional[Callable] = None,
                            score_cutoff: Optional[float] = None
                            ) -> Optional[ScoreAlignment]:
    """Best-window ``ratio`` plus where that window sits.

    >>> from rapidfuzz_tpu import fuzz
    >>> a = fuzz.partial_ratio_alignment("needle", "say needle here")
    >>> (round(a.score, 4), a.dest_start, a.dest_end)
    (1.0, 4, 10)
    """
    s1, s2 = _processed(s1, s2, processor)
    u1, u2 = _codec.encode_one(s1), _codec.encode_one(s2)
    if u1.size <= u2.size:
        score, (ws, we) = _best_window(u1, u2)
        align = ScoreAlignment(score, 0, int(u1.size), ws, we)
    else:
        score, (ws, we) = _best_window(u2, u1)
        align = ScoreAlignment(score, ws, we, 0, int(u2.size))
    if score_cutoff is not None and score < score_cutoff:
        return None
    return align


def partial_ratio(s1, s2, *, processor: Optional[Callable] = None,
                  score_cutoff: Optional[float] = None) -> Optional[float]:
    """Best ``ratio`` of the shorter string over sliding windows of the
    longer (ecosystem ``fuzz.partial_ratio``; absent from the crate,
    ``fuzz.rs:207-213``).

    >>> from rapidfuzz_tpu import fuzz
    >>> fuzz.partial_ratio("this is a test", "this is a test!")
    1.0
    """
    a = partial_ratio_alignment(s1, s2, processor=processor)
    return _c.apply_similarity_cutoff(a.score, score_cutoff)


def partial_ratio_alignment_many(s1, choices, *,
                                 processor: Optional[Callable] = None,
                                 score_cutoff: Optional[float] = None):
    """One-vs-many best-window alignments (``list[ScoreAlignment]``;
    entries under ``score_cutoff`` are ``None``).

    >>> from rapidfuzz_tpu import fuzz
    >>> a = fuzz.partial_ratio_alignment_many("needle", ["say needle here"])
    >>> (a[0].score, a[0].dest_start, a[0].dest_end)
    (1.0, 4, 10)
    """
    if processor is not None:
        s1 = processor(s1)
        choices = [processor(c) for c in choices]
    uq = _codec.encode_one(s1)
    ucs = [_codec.encode_one(c) for c in choices]
    res = [partial_ratio_alignment(uq, uc) for uc in ucs]
    if score_cutoff is not None:
        res = [a if a is not None and a.score >= score_cutoff else None
               for a in res]
    return res


def _tokens(s) -> list:
    if isinstance(s, (bytes, bytearray)):
        return bytes(s).split()
    if not isinstance(s, str):
        raise TypeError("token-based scorers need str or bytes input")
    return s.split()


def _join(tokens, sep):
    return sep.join(tokens)


def _token_sorted(s):
    sep = b" " if isinstance(s, (bytes, bytearray)) else " "
    return _join(sorted(_tokens(s)), sep)


def token_sort_ratio(s1, s2, *, processor: Optional[Callable] = None,
                     score_cutoff: Optional[float] = None
                     ) -> Optional[float]:
    """``ratio`` of the whitespace tokens sorted and re-joined.

    >>> from rapidfuzz_tpu import fuzz
    >>> fuzz.token_sort_ratio("fuzzy wuzzy was a bear",
    ...                       "wuzzy fuzzy was a bear")
    1.0
    """
    s1, s2 = _processed(s1, s2, processor)
    return ratio(_token_sorted(s1), _token_sorted(s2),
                 score_cutoff=score_cutoff)


def _token_set_parts(s1, s2):
    t1, t2 = set(_tokens(s1)), set(_tokens(s2))
    sep = b" " if isinstance(s1, (bytes, bytearray)) else " "
    inter = _join(sorted(t1 & t2), sep)
    d1 = _join(sorted(t1 - t2), sep)
    d2 = _join(sorted(t2 - t1), sep)
    j1 = inter + sep + d1 if inter and d1 else (inter or d1)
    j2 = inter + sep + d2 if inter and d2 else (inter or d2)
    return inter, d1, d2, j1, j2


def token_set_ratio(s1, s2, *, processor: Optional[Callable] = None,
                    score_cutoff: Optional[float] = None
                    ) -> Optional[float]:
    """Set-algebra ``ratio``: max over {sect vs sect+diff1, sect vs
    sect+diff2, sect+diff1 vs sect+diff2} (the classic fuzzywuzzy /
    rapidfuzz construction).

    >>> from rapidfuzz_tpu import fuzz
    >>> fuzz.token_set_ratio("fuzzy was a bear", "fuzzy fuzzy was a bear")
    1.0
    """
    s1, s2 = _processed(s1, s2, processor)
    inter, d1, d2, j1, j2 = _token_set_parts(s1, s2)
    best = ratio(j1, j2)
    if inter:
        best = max(best, ratio(inter, j1), ratio(inter, j2))
    return _c.apply_similarity_cutoff(best, score_cutoff)


def token_ratio(s1, s2, *, processor: Optional[Callable] = None,
                score_cutoff: Optional[float] = None) -> Optional[float]:
    """``max(token_sort_ratio, token_set_ratio)``.

    >>> from rapidfuzz_tpu import fuzz
    >>> fuzz.token_ratio("fuzzy was a bear", "fuzzy fuzzy was a bear")
    1.0
    """
    s1, s2 = _processed(s1, s2, processor)
    best = max(token_sort_ratio(s1, s2), token_set_ratio(s1, s2))
    return _c.apply_similarity_cutoff(best, score_cutoff)


def partial_token_sort_ratio(s1, s2, *, processor: Optional[Callable] = None,
                             score_cutoff: Optional[float] = None
                             ) -> Optional[float]:
    """``partial_ratio`` of the sorted-token joins.

    >>> from rapidfuzz_tpu import fuzz
    >>> fuzz.partial_token_sort_ratio("fuzzy wuzzy", "wuzzy fuzzy bear")
    1.0
    """
    s1, s2 = _processed(s1, s2, processor)
    return partial_ratio(_token_sorted(s1), _token_sorted(s2),
                         score_cutoff=score_cutoff)


def partial_token_set_ratio(s1, s2, *, processor: Optional[Callable] = None,
                            score_cutoff: Optional[float] = None
                            ) -> Optional[float]:
    """1.0 on any shared token, else ``partial_ratio`` of the sorted
    difference joins (the ecosystem's shortcut semantics).

    >>> from rapidfuzz_tpu import fuzz
    >>> fuzz.partial_token_set_ratio("fuzzy bear", "a fuzzy thing")
    1.0
    """
    s1, s2 = _processed(s1, s2, processor)
    inter, d1, d2, _, _ = _token_set_parts(s1, s2)
    if inter:
        return _c.apply_similarity_cutoff(1.0, score_cutoff)
    return partial_ratio(d1, d2, score_cutoff=score_cutoff)


def partial_token_ratio(s1, s2, *, processor: Optional[Callable] = None,
                        score_cutoff: Optional[float] = None
                        ) -> Optional[float]:
    """``max(partial_token_sort_ratio, partial_token_set_ratio)``.

    >>> from rapidfuzz_tpu import fuzz
    >>> fuzz.partial_token_ratio("wuzzy fuzzy", "fuzzy wuzzy was a bear")
    1.0
    """
    s1, s2 = _processed(s1, s2, processor)
    best = max(partial_token_sort_ratio(s1, s2),
               partial_token_set_ratio(s1, s2))
    return _c.apply_similarity_cutoff(best, score_cutoff)


def WRatio(s1, s2, *, processor: Optional[Callable] = None,
           score_cutoff: Optional[float] = None) -> Optional[float]:
    """Weighted combination of the fuzz scorers (ecosystem ``WRatio``),
    in [0, 1].

    >>> from rapidfuzz_tpu import fuzz
    >>> round(fuzz.WRatio("this is a test", "this is a new test!!!"), 4)
    0.855
    """
    s1, s2 = _processed(s1, s2, processor)
    u1, u2 = _codec.encode_one(s1), _codec.encode_one(s2)
    if u1.size == 0 or u2.size == 0:
        score = 1.0 if u1.size == u2.size else 0.0
        return _c.apply_similarity_cutoff(score, score_cutoff)
    UNBASE_SCALE = 0.95
    len_ratio = max(u1.size, u2.size) / min(u1.size, u2.size)
    end_ratio = ratio(s1, s2)
    if len_ratio < 1.5:
        score = max(end_ratio, token_ratio(s1, s2) * UNBASE_SCALE)
    else:
        partial_scale = 0.9 if len_ratio < 8.0 else 0.6
        score = max(end_ratio, partial_ratio(s1, s2) * partial_scale,
                    partial_token_ratio(s1, s2) * UNBASE_SCALE
                    * partial_scale)
    return _c.apply_similarity_cutoff(score, score_cutoff)


def QRatio(s1, s2, *, processor: Optional[Callable] = None,
           score_cutoff: Optional[float] = None) -> Optional[float]:
    """Quick ratio: ``ratio`` plus the empty-input convention (ecosystem
    ``QRatio``).

    >>> from rapidfuzz_tpu import fuzz
    >>> round(fuzz.QRatio("this is a test", "this is a test!"), 4)
    0.9655
    """
    s1, s2 = _processed(s1, s2, processor)
    return ratio(s1, s2, score_cutoff=score_cutoff)


# ------------------------------------------------- one-vs-many batch forms

def _aligned_ratio(arrs1, arrs2, score_cutoff=None) -> np.ndarray:
    """Elementwise indel normalized similarity of two aligned encoded
    groups (device batch).  One-vs-many batches at corpus scale ride the
    Pallas scan (same f64 finish, bit-identical).

    A ratio ``score_cutoff`` converts to the bucket-wide indel bound
    ``(1 - c) * (len1 + max len2)`` and routes the banded LCS kernel
    (``indel.rs:80-104``); entries the band rejects have a true ratio
    below the cutoff (the global bound over-covers every shorter
    candidate), so the final similarity mask is unchanged.
    """
    from .distance import _int_metric
    from .ops import lcs as _lcs_ops
    if len(arrs1) == 1 and len(arrs2) >= _int_metric.SCAN_MIN:
        dcut = None
        if score_cutoff is not None and score_cutoff > 0:
            l1 = _codec.encode_one(arrs1[0]).size
            lmax = max((_codec.encode_one(a).size for a in arrs2),
                       default=0)
            dcut = int((1.0 - score_cutoff) * (l1 + lmax)) + 1
        d = _int_metric.scan_one_vs_many("indel", arrs1[0], arrs2,
                                         score_cutoff=dcut)
        if d is not None:
            l1 = np.int64(_codec.encode_one(arrs1[0]).size)
            l2 = np.array([_codec.encode_one(a).size for a in arrs2],
                          np.int64)
            mx = l1 + l2
            return 1.0 - np.where(mx == 0, 0.0, d / np.maximum(mx, 1))
    c1, l1, c2, l2 = _codec.encode_pair_batch(arrs1, arrs2)
    sim = _dispatch.run_pairs(_lcs_ops.lcs_similarity, c1, l1, c2, l2)
    mx = l1.astype(np.int64) + l2.astype(np.int64)
    dist = mx - 2 * sim.astype(np.int64)
    return 1.0 - np.where(mx == 0, 0.0, dist / np.maximum(mx, 1))


def ratio_many(s1, choices, *, processor: Optional[Callable] = None,
               score_cutoff: Optional[float] = None
               ) -> _dispatch.BatchResult:
    """One-vs-many ``ratio`` (device batch).

    >>> from rapidfuzz_tpu import fuzz
    >>> [round(float(v), 4) for v in
    ...  fuzz.ratio_many("abc", ["abc", "abd", ""]).values]
    [1.0, 0.6667, 0.0]
    """
    if processor is not None:
        s1 = processor(s1)
        choices = [processor(c) for c in choices]
    vals = _aligned_ratio([_codec.encode_one(s1)],
                          [_codec.encode_one(c) for c in choices],
                          score_cutoff=score_cutoff)
    return _dispatch.BatchResult(*_c.mask_similarity(vals, score_cutoff))


def partial_ratio_many(s1, choices, *,
                       processor: Optional[Callable] = None,
                       score_cutoff: Optional[float] = None
                       ) -> _dispatch.BatchResult:
    """One-vs-many ``partial_ratio``: every choice's clipped windows are
    flattened into shared device batches (one dispatch per ~4M chars)
    instead of one scan per pair."""
    if processor is not None:
        s1 = processor(s1)
        choices = [processor(c) for c in choices]
    uq = _codec.encode_one(s1)
    ucs = [_codec.encode_one(c) for c in choices]
    out = _host_window_scores(uq, ucs)
    return _dispatch.BatchResult(*_c.mask_similarity(out, score_cutoff))


def _host_window_scores(uq: np.ndarray, ucs) -> np.ndarray:
    """Host window sweep: every choice's clipped windows flattened into
    shared device batches (one dispatch per ~4M chars)."""
    m = int(uq.size)
    out = np.zeros(len(ucs), np.float64)
    # pairs where the query is the (weakly) shorter side vs where the
    # choice is strictly shorter (roles swap: query windows vs choice)
    lefts, rights, owner = [], [], []
    for ci, uc in enumerate(ucs):
        n = int(uc.size)
        if min(m, n) == 0:
            out[ci] = 1.0 if max(m, n) == 0 else 0.0
            continue
        if m <= n:
            short, long_ = uq, uc
        else:
            short, long_ = uc, uq
        sm, ln = int(short.size), int(long_.size)
        for i in range(1, ln + sm):
            lefts.append(short)
            rights.append(long_[max(0, i - sm):min(ln, i)])
            owner.append(ci)
    chunk = max(256, (1 << 22) // max(m, 1))
    for lo in range(0, len(lefts), chunk):
        r = _aligned_ratio(lefts[lo:lo + chunk], rights[lo:lo + chunk])
        for k, v in zip(owner[lo:lo + chunk], r):
            if v > out[k]:
                out[k] = v
    return out


def token_sort_ratio_many(s1, choices, *,
                          processor: Optional[Callable] = None,
                          score_cutoff: Optional[float] = None
                          ) -> _dispatch.BatchResult:
    if processor is not None:
        s1 = processor(s1)
        choices = [processor(c) for c in choices]
    return ratio_many(_token_sorted(s1),
                      [_token_sorted(c) for c in choices],
                      score_cutoff=score_cutoff)


def token_set_ratio_many(s1, choices, *,
                         processor: Optional[Callable] = None,
                         score_cutoff: Optional[float] = None
                         ) -> _dispatch.BatchResult:
    if processor is not None:
        s1 = processor(s1)
        choices = [processor(c) for c in choices]
    inters, j1s, j2s = [], [], []
    for c in choices:
        inter, _, _, j1, j2 = _token_set_parts(s1, c)
        inters.append(inter)
        j1s.append(j1)
        j2s.append(j2)
    e = _codec.encode_one
    best = _aligned_ratio([e(a) for a in j1s], [e(b) for b in j2s])
    has = np.array([bool(i) for i in inters])
    if has.any():
        r1 = _aligned_ratio([e(i) for i in inters], [e(a) for a in j1s])
        r2 = _aligned_ratio([e(i) for i in inters], [e(b) for b in j2s])
        best = np.where(has, np.maximum(best, np.maximum(r1, r2)), best)
    return _dispatch.BatchResult(*_c.mask_similarity(best, score_cutoff))


def token_ratio_many(s1, choices, *,
                     processor: Optional[Callable] = None,
                     score_cutoff: Optional[float] = None
                     ) -> _dispatch.BatchResult:
    if processor is not None:
        s1 = processor(s1)
        choices = [processor(c) for c in choices]
    a = token_sort_ratio_many(s1, choices).values
    b = token_set_ratio_many(s1, choices).values
    return _dispatch.BatchResult(*_c.mask_similarity(np.maximum(a, b),
                                                     score_cutoff))


def partial_token_sort_ratio_many(s1, choices, *,
                                  processor: Optional[Callable] = None,
                                  score_cutoff: Optional[float] = None
                                  ) -> _dispatch.BatchResult:
    if processor is not None:
        s1 = processor(s1)
        choices = [processor(c) for c in choices]
    return partial_ratio_many(_token_sorted(s1),
                              [_token_sorted(c) for c in choices],
                              score_cutoff=score_cutoff)


def partial_token_set_ratio_many(s1, choices, *,
                                 processor: Optional[Callable] = None,
                                 score_cutoff: Optional[float] = None
                                 ) -> _dispatch.BatchResult:
    if processor is not None:
        s1 = processor(s1)
        choices = [processor(c) for c in choices]
    d1s, d2s, has = [], [], []
    for c in choices:
        inter, d1, d2, _, _ = _token_set_parts(s1, c)
        has.append(bool(inter))
        d1s.append(d1)
        d2s.append(d2)
    has = np.array(has)
    vals = np.ones(len(choices), np.float64)
    if (~has).any():
        # the diff strings differ per pair, so no shared window batch;
        # score those pairs through the scalar path (still the device
        # LCS kernel per call)
        for k in np.flatnonzero(~has):
            vals[k] = partial_ratio(d1s[k], d2s[k])
    return _dispatch.BatchResult(*_c.mask_similarity(vals, score_cutoff))


def partial_token_ratio_many(s1, choices, *,
                             processor: Optional[Callable] = None,
                             score_cutoff: Optional[float] = None
                             ) -> _dispatch.BatchResult:
    if processor is not None:
        s1 = processor(s1)
        choices = [processor(c) for c in choices]
    a = partial_token_sort_ratio_many(s1, choices).values
    b = partial_token_set_ratio_many(s1, choices).values
    return _dispatch.BatchResult(*_c.mask_similarity(np.maximum(a, b),
                                                     score_cutoff))


def WRatio_many(s1, choices, *, processor: Optional[Callable] = None,
                score_cutoff: Optional[float] = None
                ) -> _dispatch.BatchResult:
    """One-vs-many ``WRatio``: the end ratio and token combinations run
    as device batches; partial scorers run only for the long-branch
    subset (``len_ratio >= 1.5``)."""
    if processor is not None:
        s1 = processor(s1)
        choices = [processor(c) for c in choices]
    UNBASE_SCALE = 0.95
    l1 = len(_codec.encode_one(s1))
    lens = np.array([len(_codec.encode_one(c)) for c in choices],
                    np.int64)
    vals = np.zeros(len(choices), np.float64)
    both = (lens > 0) & (l1 > 0)
    vals[(lens == 0) & (l1 == 0)] = 1.0
    if both.any():
        end_r = ratio_many(s1, choices).values
        len_ratio = np.maximum(l1, lens) / np.maximum(
            np.minimum(l1, lens), 1)
        short = both & (len_ratio < 1.5)
        if short.any():
            tr = token_ratio_many(s1, choices).values
            vals = np.where(short, np.maximum(end_r, tr * UNBASE_SCALE),
                            vals)
        long_ = both & ~short
        if long_.any():
            idx = np.flatnonzero(long_)
            subset = [choices[i] for i in idx]
            pr = partial_ratio_many(s1, subset).values
            ptr = partial_token_ratio_many(s1, subset).values
            scale = np.where(len_ratio[idx] < 8.0, 0.9, 0.6)
            vals[idx] = np.maximum(
                end_r[idx],
                np.maximum(pr * scale, ptr * UNBASE_SCALE * scale))
    return _dispatch.BatchResult(*_c.mask_similarity(vals, score_cutoff))


def QRatio_many(s1, choices, *, processor: Optional[Callable] = None,
                score_cutoff: Optional[float] = None
                ) -> _dispatch.BatchResult:
    return ratio_many(s1, choices, processor=processor,
                      score_cutoff=score_cutoff)


# fuzz.ratio == indel normalized_similarity (fuzz.rs:60-85): bind it to a
# C vectorcall object (native/rf_scalar.cpp FastMetric id 0 / kind 3 /
# maximum len1+len2) so the str/bytes one-shot runs without Python
# frames.  Calls with a processor= keyword fall back to the closure.
_mkfn = getattr(_oracle.fast_scalar(), "make_metric_fn", None)
if _mkfn is not None:
    __test__ = {"fuzz.ratio": ratio.__doc__}
    _cr = _mkfn(0, 3, 1, ratio)
    _cr.__doc__ = ratio.__doc__
    _cr.__name__ = "ratio"
    _cr.__qualname__ = "ratio"
    _cr.__module__ = ratio.__module__
    ratio = _cr
    del _cr
