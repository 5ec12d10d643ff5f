"""Levenshtein distance (uniform + weighted).

Public surface mirrors the reference module
``/root/reference/src/distance/levenshtein.rs``: the 8 score functions,
``Args`` + ``WeightTable`` builders, and a ``BatchComparator`` — extended
with device batch APIs (``distance_many`` and
``BatchComparator.distances``) that run the Pallas/XLA kernels over padded
length buckets.

Semantics:
* ``maximum`` follows ``levenshtein.rs:263-277`` (weighted formula; uniform
  reduces to ``max(len1, len2)``).
* weight special cases (``levenshtein.rs:1244-1279``): ins==del==0 -> 0;
  uniform*factor; sub >= ins+del -> indel*factor; both are algebraic
  identities of the generalized Wagner-Fischer recurrence, so the device
  path computes them with the matching fast kernel.
* cutoff/hint semantics per ``rapidfuzz_tpu.common``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import common as _c
from .. import oracle as _oracle
from ..ops import dispatch as _dispatch
from ..ops import levenshtein as _ops
from ..utils import codec as _codec
from . import _int_metric

__all__ = [
    "WeightTable", "as_weight_table", "Args", "distance", "similarity",
    "normalized_distance",
    "normalized_similarity", "distance_with_args", "similarity_with_args",
    "normalized_distance_with_args", "normalized_similarity_with_args",
    "BatchComparator", "distance_many", "similarity_many",
    "normalized_distance_many", "normalized_similarity_many", "maximum",
    "editops", "opcodes", "editops_many",
]


def editops(s1, s2):
    """Minimal uniform-Levenshtein edit script (``Editops``).

    Beyond the reference crate (whose recording hooks are dead
    scaffolding, ``levenshtein.rs:176-210``); matches the wider rapidfuzz
    ecosystem's alignment API.  The bit-rows are recorded by the device
    kernel; the traceback runs on host.

    >>> from rapidfuzz_tpu.distance import levenshtein
    >>> [(o.tag, o.src_pos, o.dest_pos)
    ...  for o in levenshtein.editops("kitten", "sitting")]
    [('replace', 0, 0), ('replace', 4, 4), ('insert', 6, 6)]
    """
    from ._editops import levenshtein_editops
    return levenshtein_editops(s1, s2)


def editops_many(s1, choices):
    """Edit scripts from ``s1`` to every choice via ONE batched recording
    dispatch (the one-vs-many alignment scan); returns ``list[Editops]``.

    >>> from rapidfuzz_tpu.distance import levenshtein
    >>> [len(o) for o in levenshtein.editops_many("kitten",
    ...                                           ["sitting", "mitten"])]
    [3, 1]
    """
    from ._editops import levenshtein_editops_many
    return levenshtein_editops_many(s1, choices)


def opcodes(s1, s2):
    """difflib-style grouped edit operations (``Opcodes``).

    >>> from rapidfuzz_tpu.distance import levenshtein
    >>> [(o.tag, o.src_start, o.src_end, o.dest_start, o.dest_end)
    ...  for o in levenshtein.opcodes("kitten", "sitting")]  # doctest: +NORMALIZE_WHITESPACE
    [('replace', 0, 1, 0, 1), ('equal', 1, 4, 1, 4), ('replace', 4, 5, 4, 5),
     ('equal', 5, 6, 5, 6), ('insert', 6, 6, 6, 7)]
    """
    return editops(s1, s2).as_opcodes()


@dataclass(frozen=True)
class WeightTable:
    """Edit-operation costs (``levenshtein.rs:129-148``)."""
    insertion_cost: int = 1
    deletion_cost: int = 1
    substitution_cost: int = 1

    @property
    def uniform(self) -> bool:
        return (self.insertion_cost == self.deletion_cost ==
                self.substitution_cost == 1)


_UNIFORM = WeightTable()


def as_weight_table(w) -> WeightTable:
    """Coerce ``weights`` to a :class:`WeightTable`.

    Plain ``(insertion, deletion, substitution)`` sequences are accepted
    for drop-in ergonomics with the rapidfuzz Python API (the reference
    crate only takes the struct form, ``levenshtein.rs:129-148``).

    >>> as_weight_table((1, 1, 2))
    WeightTable(insertion_cost=1, deletion_cost=1, substitution_cost=2)
    """
    if w is None:
        return _UNIFORM
    if isinstance(w, WeightTable):
        return w
    ins, dele, sub = w
    return WeightTable(int(ins), int(dele), int(sub))


class Args(_c.ArgsBase):
    __slots__ = ("weights_",)

    def __init__(self):
        super().__init__()
        self.weights_ = _UNIFORM

    def weights(self, w: WeightTable):
        new = self._copy()
        new.weights_ = as_weight_table(w)
        return new


def maximum(len1, len2, weights: WeightTable = _UNIFORM):
    """Maximum possible distance (``levenshtein.rs:263-277``); vectorises
    over numpy length arrays."""
    weights = as_weight_table(weights)
    ins, dele, sub = (weights.insertion_cost, weights.deletion_cost,
                      weights.substitution_cost)
    if type(len1) is int and type(len2) is int:    # scalar fast path
        alt = (len2 * sub + (len1 - len2) * dele if len1 >= len2
               else len1 * sub + (len2 - len1) * ins)
        return min(len1 * dele + len2 * ins, alt)
    l1 = np.asarray(len1, np.int64)
    l2 = np.asarray(len2, np.int64)
    max_dist = l1 * dele + l2 * ins
    alt = np.where(l1 >= l2, l2 * sub + (l1 - l2) * dele,
                   l1 * sub + (l2 - l1) * ins)
    out = np.minimum(max_dist, alt)
    return int(out) if out.ndim == 0 else out


# ------------------------------------------------------------- scalar core

def _raw_distance(u1: np.ndarray, u2: np.ndarray, weights: WeightTable,
                  cutoff: Optional[int] = None,
                  hint: Optional[int] = None) -> int:
    """True weighted distance of two encoded arrays (host oracle path).

    ``cutoff``/``hint`` are in DISTANCE units: the result is exact when it
    is <= cutoff, else any value > cutoff (the reference's one-shot
    pruning, ``levenshtein.rs:1104-1222``); a hint seeds the band ladder
    without affecting exactness.
    """
    ins, dele, sub = (weights.insertion_cost, weights.deletion_cost,
                      weights.substitution_cost)
    if ins == dele:
        if ins == 0:
            return 0
        if ins == sub:
            # every edit costs `ins`, so distance = ins * uniform distance
            # and a distance cutoff divides through
            cut_u = None if cutoff is None else cutoff // ins
            hint_u = None if hint is None else max(hint // ins, 1)
            return ins * _oracle.levenshtein_uniform_auto(
                u1, u2, cutoff=cut_u, hint=hint_u)
        if sub >= ins + dele:
            return ins * (_oracle.indel(u1, u2) if ins != 0 else 0)
    return _oracle.levenshtein_weighted(u1, u2, ins, dele, sub)


def _scalar(s1, s2, weights: WeightTable,
            cutoff: Optional[int] = None,
            hint: Optional[int] = None) -> tuple[int, int]:
    """(raw_distance, maximum) for a scalar pair.

    The raw distance is exact when <= ``cutoff`` (distance units), else
    any value above it — callers mask with the cutoff algebra.
    """
    weights = as_weight_table(weights)
    if (type(s1) in (str, bytes) and type(s2) in (str, bytes)
            and _c.scalar_backend() != "device"):
        fast = _oracle.fast_scalar()
        if fast is not None:
            # in-process C path: reads str/bytes elements directly
            # (native/rf_scalar.cpp), the reference's one-shot latency
            ins, dele, sub = (weights.insertion_cost,
                              weights.deletion_cost,
                              weights.substitution_cost)
            mx = maximum(len(s1), len(s2), weights)
            if ins == dele:
                if ins == 0:
                    return 0, mx
                if ins == sub:
                    cut_u = -1 if cutoff is None else cutoff // ins
                    hint_u = -1 if hint is None else max(hint // ins, 1)
                    return ins * fast.lev_uniform(s1, s2, cut_u,
                                                  hint_u), mx
                if sub >= ins + dele:
                    return ins * fast.int_metric(0, s1, s2), mx
            return fast.lev_weighted(s1, s2, ins, dele, sub), mx
    u1, u2 = _codec.encode_one(s1), _codec.encode_one(s2)
    # long pairs stay on the host C path under the device backend too: a
    # one-pair batch's [LB, LA] equality plane grows with their product
    if _c.scalar_backend() == "device" and u1.size * u2.size <= 1_000_000:
        c1, l1, c2, l2 = _codec.encode_pair_batch([u1], [u2])
        dist = int(_raw_distance_batch(c1, l1, c2, l2, weights)[0])
    else:
        dist = _raw_distance(u1, u2, weights, cutoff, hint)
    return dist, maximum(u1.size, u2.size, weights)


# ------------------------------------------------------------- public scalar


def _len2(s1, s2):
    """(len1, len2, s1', s2') without encoding when inputs are str/bytes
    (the C fast path reads them directly)."""
    if type(s1) in (str, bytes) and type(s2) in (str, bytes):
        return len(s1), len(s2), s1, s2
    u1, u2 = _codec.encode_one(s1), _codec.encode_one(s2)
    return int(u1.size), int(u2.size), u1, u2


def distance(s1, s2, *, weights: WeightTable = _UNIFORM,
             score_cutoff: Optional[int] = None,
             score_hint: Optional[int] = None) -> Optional[int]:
    """Levenshtein distance (uniform or weighted).

    >>> from rapidfuzz_tpu.distance import levenshtein
    >>> levenshtein.distance("kitten", "sitting")
    3
    >>> levenshtein.distance("kitten", "sitting", score_cutoff=2) is None
    True
    >>> levenshtein.distance("kitten", "sitting",
    ...                      weights=levenshtein.WeightTable(1, 1, 2))
    5
    """
    # uniform str/bytes one-shot: single C-extension call (the
    # reference's dominant latency class; frames cost here)
    if (weights is _UNIFORM and type(s1) in (str, bytes)
            and type(s2) in (str, bytes)
            and _c.scalar_backend() != "device"):
        fast = _oracle.fast_scalar()
        if fast is not None:
            cut = -1 if score_cutoff is None else score_cutoff
            hint = -1 if score_hint is None else max(score_hint, 1)
            d = fast.lev_uniform(s1, s2, cut, hint)
            if d is not None:
                if score_cutoff is None or d <= score_cutoff:
                    return d
                return None
    dist, _ = _scalar(s1, s2, weights, score_cutoff, score_hint)
    return _c.apply_distance_cutoff(dist, score_cutoff)


def similarity(s1, s2, *, weights: WeightTable = _UNIFORM,
               score_cutoff: Optional[int] = None,
               score_hint: Optional[int] = None) -> Optional[int]:
    """Levenshtein similarity (``maximum - distance``).

    >>> from rapidfuzz_tpu.distance import levenshtein
    >>> levenshtein.similarity("kitten", "sitting")
    4
    """
    l1, l2, s1, s2 = _len2(s1, s2)
    mx0 = maximum(l1, l2, weights)
    dcut = None if score_cutoff is None else max(mx0 - score_cutoff, 0)
    dhint = None if score_hint is None else max(mx0 - score_hint, 0)
    dist, mx = _scalar(s1, s2, weights, dcut, dhint)
    return _c.apply_similarity_cutoff(mx - dist, score_cutoff)


def normalized_distance(s1, s2, *, weights: WeightTable = _UNIFORM,
                        score_cutoff: Optional[float] = None,
                        score_hint: Optional[float] = None) -> Optional[float]:
    """Levenshtein distance normalized to [0, 1].

    >>> from rapidfuzz_tpu.distance import levenshtein
    >>> round(levenshtein.normalized_distance("kitten", "sitting"), 4)
    0.4286
    """
    l1, l2, s1, s2 = _len2(s1, s2)
    mx0 = maximum(l1, l2, weights)
    dcut = (None if score_cutoff is None
            else int(score_cutoff * mx0) + 1)      # over-covering band
    dhint = None if score_hint is None else int(score_hint * mx0) + 1
    dist, mx = _scalar(s1, s2, weights, dcut, dhint)
    return _c.apply_distance_cutoff(_c.norm_dist_from_dist(dist, mx),
                                    score_cutoff)


def normalized_similarity(s1, s2, *, weights: WeightTable = _UNIFORM,
                          score_cutoff: Optional[float] = None,
                          score_hint: Optional[float] = None) -> Optional[float]:
    """Levenshtein similarity normalized to [0, 1].

    >>> from rapidfuzz_tpu.distance import levenshtein
    >>> round(levenshtein.normalized_similarity("kitten", "sitting"), 4)
    0.5714
    """
    l1, l2, s1, s2 = _len2(s1, s2)
    mx0 = maximum(l1, l2, weights)
    dcut = (None if score_cutoff is None
            else int((1.0 - score_cutoff) * mx0) + 1)
    dhint = (None if score_hint is None
             else int((1.0 - score_hint) * mx0) + 1)
    dist, mx = _scalar(s1, s2, weights, dcut, dhint)
    return _c.apply_similarity_cutoff(1.0 - _c.norm_dist_from_dist(dist, mx),
                                      score_cutoff)


def distance_with_args(s1, s2, args: Args):
    return distance(s1, s2, weights=args.weights_, score_cutoff=args.cutoff,
                    score_hint=args.hint)


def similarity_with_args(s1, s2, args: Args):
    return similarity(s1, s2, weights=args.weights_, score_cutoff=args.cutoff,
                      score_hint=args.hint)


def normalized_distance_with_args(s1, s2, args: Args):
    return normalized_distance(s1, s2, weights=args.weights_,
                               score_cutoff=args.cutoff, score_hint=args.hint)


def normalized_similarity_with_args(s1, s2, args: Args):
    return normalized_similarity(s1, s2, weights=args.weights_,
                                 score_cutoff=args.cutoff, score_hint=args.hint)


# ----------------------------------------------------------- batch (device)

def _raw_distance_batch(c1, l1, c2, l2, weights: WeightTable) -> np.ndarray:
    """Device batched raw distances for padded encoded batches."""
    ins, dele, sub = (weights.insertion_cost, weights.deletion_cost,
                      weights.substitution_cost)
    if ins == dele:
        if ins == 0:
            return np.zeros(np.broadcast_shapes(l1.shape, l2.shape), np.int64)
        if ins == sub:
            d = _dispatch.run_pairs(_ops.uniform_distance, c1, l1, c2, l2)
            return d.astype(np.int64) * ins
        if sub >= ins + dele:
            from ..ops import lcs as _lcs_ops
            sim = _dispatch.run_pairs(_lcs_ops.lcs_similarity, c1, l1, c2, l2)
            return (l1.astype(np.int64) + l2.astype(np.int64)
                    - 2 * sim.astype(np.int64)) * ins
    # the device Wagner-Fischer kernels carry int32 cells; when the worst
    # case D[0][LB] = LB*ins (+ headroom) could wrap, compute the batch on
    # the int64 host oracle instead of silently overflowing
    bound = (int(c1.shape[-1]) * max(dele, sub, 1)
             + int(c2.shape[-1]) * max(ins, sub, 1))
    if bound >= 2 ** 31:
        B = max(len(l1), len(l2))
        c1b = np.broadcast_to(c1, (B, c1.shape[-1]))
        c2b = np.broadcast_to(c2, (B, c2.shape[-1]))
        l1b = np.broadcast_to(l1, (B,))
        l2b = np.broadcast_to(l2, (B,))
        return np.array([
            _oracle.levenshtein_weighted(
                c1b[i, : l1b[i]].astype(np.int64),
                c2b[i, : l2b[i]].astype(np.int64), ins, dele, sub)
            for i in range(B)], np.int64)
    d = _dispatch.run_pairs(_ops.weighted_distance, c1, l1, c2, l2,
                            ins=ins, dele=dele, sub=sub)
    return d.astype(np.int64)


def _batch_raw(s1s, s2s, weights: WeightTable):
    weights = as_weight_table(weights)
    if len(s1s) == 1 and len(s2s) >= _int_metric.SCAN_MIN:
        d = _int_metric.scan_one_vs_many("levenshtein", s1s[0], s2s,
                                         weights=weights)
        if d is not None:
            l2 = np.array([_codec.encode_one(s).size for s in s2s],
                          np.int64)
            l1 = np.full_like(l2, _codec.encode_one(s1s[0]).size)
            return d, maximum(l1, l2, weights)
    c1, l1, c2, l2 = _codec.encode_pair_batch(s1s, s2s)
    dist = _raw_distance_batch(c1, l1, c2, l2, weights)
    B = max(len(l1), len(l2))
    l1b = np.broadcast_to(l1, (B,)).astype(np.int64)
    l2b = np.broadcast_to(l2, (B,)).astype(np.int64)
    return dist, maximum(l1b, l2b, weights)


def distance_many(s1s, s2s, *, weights: WeightTable = _UNIFORM,
                  score_cutoff: Optional[int] = None) -> _dispatch.BatchResult:
    """Elementwise distances for two aligned batches (device path)."""
    dist, _ = _batch_raw(s1s, s2s, weights)
    return _dispatch.BatchResult(*_c.mask_distance(dist, score_cutoff))


def similarity_many(s1s, s2s, *, weights: WeightTable = _UNIFORM,
                    score_cutoff=None) -> _dispatch.BatchResult:
    dist, mx = _batch_raw(s1s, s2s, weights)
    return _dispatch.BatchResult(*_c.mask_similarity(mx - dist, score_cutoff))


def normalized_distance_many(s1s, s2s, *, weights: WeightTable = _UNIFORM,
                             score_cutoff=None) -> _dispatch.BatchResult:
    dist, mx = _batch_raw(s1s, s2s, weights)
    nd = np.where(mx == 0, 0.0, dist / np.maximum(mx, 1))
    return _dispatch.BatchResult(*_c.mask_distance(nd, score_cutoff))


def normalized_similarity_many(s1s, s2s, *, weights: WeightTable = _UNIFORM,
                               score_cutoff=None) -> _dispatch.BatchResult:
    dist, mx = _batch_raw(s1s, s2s, weights)
    ns = 1.0 - np.where(mx == 0, 0.0, dist / np.maximum(mx, 1))
    return _dispatch.BatchResult(*_c.mask_similarity(ns, score_cutoff))


# ---------------------------------------------------------- BatchComparator

class BatchComparator:
    """One-vs-many comparator (``levenshtein.rs:1625-1818``).

    The reference caches the query's PM bitvector table; the device
    equivalent keeps the encoded query (the XLA kernels derive PM columns
    via compare+pack, the GPU scan kernel builds the table per scan) and
    reuses the compiled one-vs-many program across calls.
    """

    def __init__(self, s1, weights: WeightTable = _UNIFORM):
        # keep the original str/bytes so scalar calls ride the C one-shot
        # route (the reference's BatchComparator is its fastest scalar
        # path); the encoded form serves non-text and batch APIs
        self._s1 = s1 if type(s1) in (str, bytes) else None
        self._u1 = _codec.encode_one(s1)
        self._weights = as_weight_table(weights)

    def _q(self, s2):
        return (self._s1 if self._s1 is not None
                and type(s2) in (str, bytes) else self._u1)

    # scalar parity API
    def distance(self, s2, **kw):
        return distance(self._q(s2), s2, weights=self._weights, **kw)

    def similarity(self, s2, **kw):
        return similarity(self._q(s2), s2, weights=self._weights, **kw)

    def normalized_distance(self, s2, **kw):
        return normalized_distance(self._q(s2), s2,
                                   weights=self._weights, **kw)

    def normalized_similarity(self, s2, **kw):
        return normalized_similarity(self._q(s2), s2,
                                     weights=self._weights, **kw)

    def distance_with_args(self, s2, args: Args):
        return distance(self._u1, s2, weights=args.weights_,
                        score_cutoff=args.cutoff, score_hint=args.hint)

    def similarity_with_args(self, s2, args: Args):
        return similarity(self._u1, s2, weights=args.weights_,
                          score_cutoff=args.cutoff, score_hint=args.hint)

    def normalized_distance_with_args(self, s2, args: Args):
        return normalized_distance(self._u1, s2, weights=args.weights_,
                                   score_cutoff=args.cutoff,
                                   score_hint=args.hint)

    def normalized_similarity_with_args(self, s2, args: Args):
        return normalized_similarity(self._u1, s2, weights=args.weights_,
                                     score_cutoff=args.cutoff,
                                     score_hint=args.hint)

    # device batch API (all 4 score kinds, levenshtein.rs:1750-1818)
    def _batch(self, corpus):
        c1, l1, c2, l2 = _codec.encode_pair_batch([self._u1], corpus)
        dist = _raw_distance_batch(c1, l1, c2, l2, self._weights)
        mx = maximum(np.int64(l1[0]), l2.astype(np.int64), self._weights)
        return dist, mx

    def distances(self, corpus, *, score_cutoff=None) -> _dispatch.BatchResult:
        dist, _ = self._batch(corpus)
        return _dispatch.BatchResult(*_c.mask_distance(dist, score_cutoff))

    def similarities(self, corpus, *, score_cutoff=None
                     ) -> _dispatch.BatchResult:
        dist, mx = self._batch(corpus)
        return _dispatch.BatchResult(*_c.mask_similarity(mx - dist,
                                                         score_cutoff))

    def normalized_distances(self, corpus, *, score_cutoff=None
                             ) -> _dispatch.BatchResult:
        dist, mx = self._batch(corpus)
        nd = np.where(mx == 0, 0.0, dist / np.maximum(mx, 1))
        return _dispatch.BatchResult(*_c.mask_distance(nd, score_cutoff))

    def normalized_similarities(self, corpus, *, score_cutoff=None
                                ) -> _dispatch.BatchResult:
        dist, mx = self._batch(corpus)
        nd = np.where(mx == 0, 0.0, dist / np.maximum(mx, 1))
        return _dispatch.BatchResult(*_c.mask_similarity(1.0 - nd, score_cutoff))


# ---------------------------------------------------------------------------
# Bind the four uniform scalar entry points to C vectorcall objects (see
# native/rf_scalar.cpp FastMetric): the str/bytes uniform one-shot — the
# reference's dominant latency class (criterion charts, BASELINE.md) —
# then runs with zero Python frames.  Weighted calls pass a ``weights``
# keyword, which the C callable does not recognize, so they fall back to
# the Python closures above; ditto wide strings, encoded arrays, exotic
# cutoffs and the device scalar backend.
_mkfn = getattr(_oracle.fast_scalar(), "make_metric_fn", None)
if _mkfn is not None:
    __test__ = {}

    def _cwrap(fn, kind):
        w = _mkfn(7, kind, 0, fn)          # id 7: uniform Levenshtein
        w.__doc__ = fn.__doc__
        w.__name__ = fn.__name__
        w.__qualname__ = fn.__qualname__
        w.__module__ = fn.__module__
        # doctest.testmod does not traverse C callables; keep their
        # examples executing via the module __test__ map
        __test__[f"levenshtein.{fn.__name__}"] = fn.__doc__
        return w

    distance = _cwrap(distance, 0)
    similarity = _cwrap(similarity, 1)
    normalized_distance = _cwrap(normalized_distance, 2)
    normalized_similarity = _cwrap(normalized_similarity, 3)
    del _cwrap
