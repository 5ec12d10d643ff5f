"""Factory for integer-valued metric modules.

Every reference metric module exposes the same 10-function surface
(SURVEY.md §2.2); this builds it from three ingredients: ``maximum``,
a scalar raw-distance function (host oracle), and a batched raw-distance
function (device kernels), with cutoff algebra from ``common.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .. import common as _c
from .. import oracle as _oracle
from ..ops import dispatch as _dispatch
from ..utils import codec as _codec


#: one-vs-many batches at least this large route through a corpus scan on
#: GPU (the scan kernel's length-sorted blocks); smaller ones stay on the
#: XLA pair kernels where layout and upload would dominate
SCAN_MIN = 4096
#: metrics the CorpusScanner serves with identical semantics (hamming is
#: excluded: the scanner pads, the batch API keeps the strict length
#: check)
_SCANNABLE = frozenset({"levenshtein", "indel", "lcs_seq", "osa",
                        "damerau_levenshtein", "prefix", "postfix",
                        "jaro", "jaro_winkler"})


def scan_one_vs_many(name: str, q, corpus, weights=None,
                     prefix_weight: float = 0.1, score_cutoff=None):
    """One-vs-many distances via a one-off CorpusScanner, or None.

    ``BatchComparator.distances`` / ``*_many([q], corpus)`` otherwise run
    the XLA pair kernels; on GPU the scanner routes the scan kernel where
    it serves the metric, and its XLA route otherwise.  The scanner build
    (encode + sort + upload) is the same order of work the pair path pays
    anyway.  Jaro-family results come back as f64 distances
    (``1 - similarity``).

    ``score_cutoff`` (a DISTANCE bound): entries above it come back with
    any value > the cutoff (callers re-apply the identical mask).
    """
    from ..ops import route as _route

    if name not in _SCANNABLE:
        return None
    if _route.default_platform() != "gpu":
        return None
    from ..parallel.scan import CorpusScanner
    sc = CorpusScanner(list(corpus), metric=name, weights=weights,
                       prefix_weight=prefix_weight)
    f64 = name in ("jaro", "jaro_winkler")
    res = sc.distances(q, score_cutoff=score_cutoff)
    if score_cutoff is not None:
        res = res.values                       # masks re-applied upstream
    return np.asarray(res, np.float64 if f64 else np.int64)


class IntMetric:
    """Bundle of the derived API functions for one integer metric.

    ``fast_distance(s1, s2) -> int | None``: optional in-process C fast
    path for str/bytes inputs (``native/rf_scalar.cpp``) — the
    reference's one-shot latency class, skipping the numpy encoder.
    """

    def __init__(self, name: str,
                 maximum: Callable[[int, int], int],
                 raw_distance: Callable[[np.ndarray, np.ndarray], int],
                 batch_distance: Callable[..., np.ndarray],
                 fast_distance=None):
        self.name = name
        self.maximum = maximum
        self.raw_distance = raw_distance
        self.batch_distance = batch_distance
        self.fast_distance = fast_distance

    # ------------------------------------------------------------- scalar
    def _scalar(self, s1, s2):
        if (self.fast_distance is not None
                and type(s1) in (str, bytes) and type(s2) in (str, bytes)
                and _c.scalar_backend() != "device"):
            d = self.fast_distance(s1, s2)
            if d is not None:
                return d, self.maximum(len(s1), len(s2))
        u1, u2 = _codec.encode_one(s1), _codec.encode_one(s2)
        mx = self.maximum(u1.size, u2.size)
        if _c.scalar_backend() == "device":
            c1, l1, c2, l2 = _codec.encode_pair_batch([u1], [u2])
            return int(np.asarray(self.batch_distance(c1, l1, c2, l2))[0]), mx
        return self.raw_distance(u1, u2), mx

    def distance(self, s1, s2, *, score_cutoff=None, score_hint=None):
        dist, _ = self._scalar(s1, s2)
        return _c.apply_distance_cutoff(dist, score_cutoff)

    def similarity(self, s1, s2, *, score_cutoff=None, score_hint=None):
        dist, mx = self._scalar(s1, s2)
        return _c.apply_similarity_cutoff(mx - dist, score_cutoff)

    def normalized_distance(self, s1, s2, *, score_cutoff=None,
                            score_hint=None):
        dist, mx = self._scalar(s1, s2)
        return _c.apply_distance_cutoff(_c.norm_dist_from_dist(dist, mx),
                                        score_cutoff)

    def normalized_similarity(self, s1, s2, *, score_cutoff=None,
                              score_hint=None):
        dist, mx = self._scalar(s1, s2)
        return _c.apply_similarity_cutoff(
            1.0 - _c.norm_dist_from_dist(dist, mx), score_cutoff)

    # -------------------------------------------------------------- batch
    def _batch_raw(self, s1s, s2s):
        if len(s1s) == 1 and len(s2s) >= SCAN_MIN:
            d = scan_one_vs_many(self.name, s1s[0], s2s)
            if d is not None:
                l2 = np.array([_codec.encode_one(s).size for s in s2s],
                              np.int64)
                l1 = np.full_like(l2, _codec.encode_one(s1s[0]).size)
                return d, self.maximum(l1, l2)
        c1, l1, c2, l2 = _codec.encode_pair_batch(s1s, s2s)
        dist = self.batch_distance(c1, l1, c2, l2)
        B = max(len(l1), len(l2))
        l1b = np.broadcast_to(l1, (B,)).astype(np.int64)
        l2b = np.broadcast_to(l2, (B,)).astype(np.int64)
        mx = self.maximum(l1b, l2b)
        return np.asarray(dist, np.int64), mx

    def distance_many(self, s1s, s2s, *, score_cutoff=None):
        dist, _ = self._batch_raw(s1s, s2s)
        return _dispatch.BatchResult(*_c.mask_distance(dist, score_cutoff))

    def similarity_many(self, s1s, s2s, *, score_cutoff=None):
        dist, mx = self._batch_raw(s1s, s2s)
        return _dispatch.BatchResult(*_c.mask_similarity(mx - dist,
                                                         score_cutoff))

    def normalized_distance_many(self, s1s, s2s, *, score_cutoff=None):
        dist, mx = self._batch_raw(s1s, s2s)
        nd = np.where(mx == 0, 0.0, dist / np.maximum(mx, 1))
        return _dispatch.BatchResult(*_c.mask_distance(nd, score_cutoff))

    def normalized_similarity_many(self, s1s, s2s, *, score_cutoff=None):
        dist, mx = self._batch_raw(s1s, s2s)
        ns = 1.0 - np.where(mx == 0, 0.0, dist / np.maximum(mx, 1))
        return _dispatch.BatchResult(*_c.mask_similarity(ns, score_cutoff))


def build_module(metric: IntMetric, ns: dict, extra_args_slots=(),
                 example=None):
    """Install the standard public surface into a module namespace.

    ``example=(s1, s2, distance)`` generates runnable doctest examples in
    each public function's docstring (the reference carries a doc test on
    every public fn, ``lib.rs:28-72``; ``tests/test_doctest.py`` executes
    them).
    """

    class Args(_c.ArgsBase):
        __slots__ = ()

    Args.__qualname__ = f"{metric.name}.Args"

    # The scalar wrappers inline the str/bytes C fast route (one closure
    # load + one extension call) — every interposed frame here is a
    # visible fraction of the reference's one-shot latency class
    # (criterion charts, SURVEY.md §6: indel/LCS 50-500 ns).
    _sb = _c.scalar_backend
    _fast = metric.fast_distance
    _mx = metric.maximum
    _SB = (str, bytes)

    def distance(s1, s2, *, score_cutoff=None, score_hint=None):
        if (_fast is not None and type(s1) in _SB and type(s2) in _SB
                and _sb() != "device"):
            d = _fast(s1, s2)
            if d is not None:
                if score_cutoff is None or d <= score_cutoff:
                    return d
                return None
        return metric.distance(s1, s2, score_cutoff=score_cutoff)

    def similarity(s1, s2, *, score_cutoff=None, score_hint=None):
        if (_fast is not None and type(s1) in _SB and type(s2) in _SB
                and _sb() != "device"):
            d = _fast(s1, s2)
            if d is not None:
                s = _mx(len(s1), len(s2)) - d
                if score_cutoff is None or s >= score_cutoff:
                    return s
                return None
        return metric.similarity(s1, s2, score_cutoff=score_cutoff)

    def normalized_distance(s1, s2, *, score_cutoff=None, score_hint=None):
        if (_fast is not None and type(s1) in _SB and type(s2) in _SB
                and _sb() != "device"):
            d = _fast(s1, s2)
            if d is not None:
                mx = _mx(len(s1), len(s2))
                nd = d / mx if mx else 0.0
                if score_cutoff is None or nd <= score_cutoff:
                    return nd
                return None
        return metric.normalized_distance(s1, s2, score_cutoff=score_cutoff)

    def normalized_similarity(s1, s2, *, score_cutoff=None, score_hint=None):
        if (_fast is not None and type(s1) in _SB and type(s2) in _SB
                and _sb() != "device"):
            d = _fast(s1, s2)
            if d is not None:
                mx = _mx(len(s1), len(s2))
                ns = 1.0 - (d / mx if mx else 0.0)
                if score_cutoff is None or ns >= score_cutoff:
                    return ns
                return None
        return metric.normalized_similarity(s1, s2,
                                            score_cutoff=score_cutoff)

    def distance_with_args(s1, s2, args):
        return metric.distance(s1, s2, score_cutoff=args.cutoff)

    def similarity_with_args(s1, s2, args):
        return metric.similarity(s1, s2, score_cutoff=args.cutoff)

    def normalized_distance_with_args(s1, s2, args):
        return metric.normalized_distance(s1, s2, score_cutoff=args.cutoff)

    def normalized_similarity_with_args(s1, s2, args):
        return metric.normalized_similarity(s1, s2, score_cutoff=args.cutoff)

    class BatchComparator:
        """One-vs-many comparator with device batch APIs.

        Scalar calls keep the original str/bytes query so they ride the
        C one-shot route (the reference's BatchComparator is its FASTEST
        scalar path, criterion charts — an encoded-array detour here was
        measured 20x slower than the one-shot API)."""

        def __init__(self, s1):
            self._s1 = s1 if type(s1) in _SB else None
            self._u1 = _codec.encode_one(s1)

        def distance(self, s2, **kw):
            if self._s1 is not None and type(s2) in _SB:
                return distance(self._s1, s2, **kw)
            return metric.distance(self._u1, s2, **kw)

        def similarity(self, s2, **kw):
            if self._s1 is not None and type(s2) in _SB:
                return similarity(self._s1, s2, **kw)
            return metric.similarity(self._u1, s2, **kw)

        def normalized_distance(self, s2, **kw):
            if self._s1 is not None and type(s2) in _SB:
                return normalized_distance(self._s1, s2, **kw)
            return metric.normalized_distance(self._u1, s2, **kw)

        def normalized_similarity(self, s2, **kw):
            if self._s1 is not None and type(s2) in _SB:
                return normalized_similarity(self._s1, s2, **kw)
            return metric.normalized_similarity(self._u1, s2, **kw)

        def distance_with_args(self, s2, args):
            return metric.distance(self._u1, s2, score_cutoff=args.cutoff)

        def similarity_with_args(self, s2, args):
            return metric.similarity(self._u1, s2, score_cutoff=args.cutoff)

        def normalized_distance_with_args(self, s2, args):
            return metric.normalized_distance(self._u1, s2,
                                              score_cutoff=args.cutoff)

        def normalized_similarity_with_args(self, s2, args):
            return metric.normalized_similarity(self._u1, s2,
                                                score_cutoff=args.cutoff)

        def distances(self, corpus, *, score_cutoff=None):
            return metric.distance_many([self._u1], corpus,
                                        score_cutoff=score_cutoff)

        def similarities(self, corpus, *, score_cutoff=None):
            return metric.similarity_many([self._u1], corpus,
                                          score_cutoff=score_cutoff)

        def normalized_distances(self, corpus, *, score_cutoff=None):
            return metric.normalized_distance_many(
                [self._u1], corpus, score_cutoff=score_cutoff)

        def normalized_similarities(self, corpus, *, score_cutoff=None):
            return metric.normalized_similarity_many(
                [self._u1], corpus, score_cutoff=score_cutoff)

    BatchComparator.__qualname__ = f"{metric.name}.BatchComparator"

    if example is not None:
        s1, s2, dist = example
        mx = metric.maximum(len(s1), len(s2))
        sim = mx - dist
        mod = ns.get("__name__", f"rapidfuzz_tpu.distance.{metric.name}")
        imp = f">>> from {mod.rsplit('.', 1)[0]} import {metric.name}"
        n = metric.name
        cut = (f"\n>>> {n}.distance({s1!r}, {s2!r}, "
               f"score_cutoff={dist - 1}) is None\nTrue"
               if dist > 0 else "")
        distance.__doc__ = (
            f"{n} distance between two sequences.\n\n"
            f"{imp}\n>>> {n}.distance({s1!r}, {s2!r})\n{dist}{cut}\n")
        similarity.__doc__ = (
            f"{n} similarity (``maximum - distance``).\n\n"
            f"{imp}\n>>> {n}.similarity({s1!r}, {s2!r})\n{sim}\n")
        normalized_distance.__doc__ = (
            f"{n} distance normalized to [0, 1].\n\n"
            f"{imp}\n>>> round({n}.normalized_distance({s1!r}, {s2!r}), 4)"
            f"\n{round(dist / mx, 4) if mx else 0.0}\n")
        normalized_similarity.__doc__ = (
            f"{n} similarity normalized to [0, 1].\n\n"
            f"{imp}\n>>> round({n}.normalized_similarity({s1!r}, {s2!r}),"
            f" 4)\n{round(1 - dist / mx, 4) if mx else 1.0}\n")
        distance_with_args.__doc__ = (
            f"{n} distance with an ``Args`` builder.\n\n"
            f"{imp}\n>>> {n}.distance_with_args({s1!r}, {s2!r}, "
            f"{n}.Args().score_cutoff({dist}))\n{dist}\n")
        similarity_with_args.__doc__ = (
            f"{n} similarity with an ``Args`` builder.\n\n"
            f"{imp}\n>>> {n}.similarity_with_args({s1!r}, {s2!r}, "
            f"{n}.Args())\n{sim}\n")
        normalized_distance_with_args.__doc__ = (
            f"Normalized {n} distance with an ``Args`` builder.\n\n"
            f"{imp}\n>>> round({n}.normalized_distance_with_args({s1!r}, "
            f"{s2!r}, {n}.Args()), 4)"
            f"\n{round(dist / mx, 4) if mx else 0.0}\n")
        normalized_similarity_with_args.__doc__ = (
            f"Normalized {n} similarity with an ``Args`` builder.\n\n"
            f"{imp}\n>>> round({n}.normalized_similarity_with_args("
            f"{s1!r}, {s2!r}, {n}.Args()), 4)"
            f"\n{round(1 - dist / mx, 4) if mx else 1.0}\n")
        BatchComparator.__doc__ = (
            f"One-vs-many {n} comparator with device batch APIs "
            f"(``BatchComparator``, SURVEY.md §2.2).\n\n"
            f"{imp}\n>>> bc = {n}.BatchComparator({s1!r})\n"
            f">>> int(bc.distances([{s2!r}]).values[0])\n{dist}\n"
            f">>> int(bc.similarities([{s2!r}]).values[0])\n{sim}\n")
        # doctest.testmod only collects functions whose __module__ is the
        # target module
        for fn in (distance, similarity, normalized_distance,
                   normalized_similarity, distance_with_args,
                   similarity_with_args, normalized_distance_with_args,
                   normalized_similarity_with_args):
            fn.__module__ = mod
        BatchComparator.__module__ = mod
        Args.__module__ = mod

    # Bind the four main entry points to C vectorcall objects when the
    # extension provides them: the whole str/bytes one-shot path (type
    # checks, kernel, cutoff algebra, result boxing) then runs without a
    # single Python frame — the wrapper stack alone costs ~250-350 ns,
    # half the reference's criterion band (BASELINE.md 50-500 ns).  The
    # Python closures stay as the fallback for every other input class,
    # and the rebinding happens before BatchComparator's cells are read
    # so its scalar route rides the C callables too.
    _ids = {"indel": 0, "lcs_seq": 1, "osa": 2,
            "damerau_levenshtein": 3, "prefix": 5, "postfix": 6}
    _mk = getattr(_oracle.fast_scalar(), "make_metric_fn", None)
    if _mk is not None and metric.name in _ids:
        _cid = _ids[metric.name]
        _maxcode = 1 if metric.name == "indel" else 0
        _test = ns.setdefault("__test__", {})

        def _cwrap(fn, kind, _nm):
            w = _mk(_cid, kind, _maxcode, fn)
            w.__doc__ = fn.__doc__
            w.__name__ = _nm
            w.__qualname__ = getattr(fn, "__qualname__", _nm)
            w.__module__ = getattr(fn, "__module__", ns.get("__name__"))
            if fn.__doc__:
                # doctest.testmod does not traverse C callables; keep
                # their examples executing via the module __test__ map
                _test[f"{metric.name}.{_nm}"] = fn.__doc__
            return w

        distance = _cwrap(distance, 0, "distance")
        similarity = _cwrap(similarity, 1, "similarity")
        normalized_distance = _cwrap(normalized_distance, 2,
                                     "normalized_distance")
        normalized_similarity = _cwrap(normalized_similarity, 3,
                                       "normalized_similarity")

    ns.update(
        Args=Args,
        distance=distance,
        similarity=similarity,
        normalized_distance=normalized_distance,
        normalized_similarity=normalized_similarity,
        distance_with_args=distance_with_args,
        similarity_with_args=similarity_with_args,
        normalized_distance_with_args=normalized_distance_with_args,
        normalized_similarity_with_args=normalized_similarity_with_args,
        BatchComparator=BatchComparator,
        distance_many=metric.distance_many,
        similarity_many=metric.similarity_many,
        normalized_distance_many=metric.normalized_distance_many,
        normalized_similarity_many=metric.normalized_similarity_many,
        maximum=metric.maximum,
    )
    ns.setdefault("__all__", [
        "Args", "distance", "similarity", "normalized_distance",
        "normalized_similarity", "distance_with_args", "similarity_with_args",
        "normalized_distance_with_args", "normalized_similarity_with_args",
        "BatchComparator", "distance_many", "similarity_many",
        "normalized_distance_many", "normalized_similarity_many", "maximum",
    ])
