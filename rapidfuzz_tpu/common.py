"""Score algebra and cutoff semantics shared by every metric.

Mirrors the observable contract of the reference's metric algebra traits
(``/root/reference/src/details/distance.rs``) and cutoff typestates
(``/root/reference/src/common.rs``):

* every metric defines ``maximum(len1, len2)`` and one primitive score; the
  other three score kinds derive from it:
  ``sim = maximum - dist``; ``norm_dist = dist / maximum`` (``0.0`` when
  ``maximum == 0``, ``distance.rs:247-251``); ``norm_sim = 1 - norm_dist``.
* ``score_cutoff`` changes the return type: distances keep ``raw <= cutoff``
  (``common.rs:43-45``), similarities keep ``raw >= cutoff``
  (``common.rs:83-85``); filtered-out results are ``None`` (scalar API) or
  masked out (batch API).  The reference's *internal* cutoff plumbing
  (inversion, ``ceil`` on normalized cutoffs, the 1e-5 imprecision constant
  in ``details/common.rs:4-7``) only prunes work and never changes which
  results survive, so this library computes true scores and applies
  the cutoff as a mask.
* ``score_hint`` is accepted everywhere for API parity; it is a pure
  performance hint in the reference (band-guess ladder,
  ``levenshtein.rs:1176-1220``) and never changes results
  (verified by ``levenshtein.rs:2153-2160``: hint 0 still exact).
"""

from __future__ import annotations

import copy
import os
from typing import Optional

import numpy as np

__all__ = [
    "ArgsBase", "apply_distance_cutoff", "apply_similarity_cutoff",
    "norm_dist_from_dist", "mask_distance", "mask_similarity",
    "scalar_backend",
]


try:
    # os.environ.get costs ~0.9 us/call (Python-level key encoding) —
    # visible against the C one-shot path (~0.15 us).  Read the backing
    # dict directly; writes through os.environ (incl. monkeypatch.setenv)
    # stay visible because _Environ mutates the same dict.
    _ENV_DATA = os.environ._data
    _SB_KEY = os.environ.encodekey("RAPIDFUZZ_TPU_SCALAR_BACKEND")

    def scalar_backend() -> str:
        """'cpp' (host oracle) or 'device' for one-shot scalar calls."""
        v = _ENV_DATA.get(_SB_KEY)
        return "cpp" if v is None else os.fsdecode(v)
except AttributeError:                     # non-CPython fallback
    def scalar_backend() -> str:
        """'cpp' (host oracle) or 'device' for one-shot scalar calls."""
        return os.environ.get("RAPIDFUZZ_TPU_SCALAR_BACKEND", "cpp")


class ArgsBase:
    """Builder-style args mirroring the reference ``Args`` typestates.

    ``Args().score_cutoff(2).score_hint(5)``; presence of a cutoff switches
    the result type from ``T`` to ``Optional[T]`` exactly like
    ``NoScoreCutoff`` / ``WithScoreCutoff`` select it at compile time in the
    reference.
    """

    __slots__ = ("cutoff", "hint")

    def __init__(self):
        self.cutoff: Optional[float] = None
        self.hint: Optional[float] = None

    def _copy(self):
        new = copy.copy(self)
        return new

    def score_cutoff(self, v):
        new = self._copy()
        new.cutoff = v
        return new

    def score_hint(self, v):
        new = self._copy()
        new.hint = v
        return new


# ------------------------------------------------------------ scalar algebra

def apply_distance_cutoff(raw, cutoff):
    """raw distance -> raw | None under a distance cutoff."""
    if cutoff is None:
        return raw
    return raw if raw <= cutoff else None


def apply_similarity_cutoff(raw, cutoff):
    if cutoff is None:
        return raw
    return raw if raw >= cutoff else None


def norm_dist_from_dist(dist, maximum) -> float:
    return 0.0 if maximum == 0 else dist / maximum


# ------------------------------------------------------------- batch algebra

def mask_distance(raw: np.ndarray, cutoff) -> tuple[np.ndarray, np.ndarray]:
    """(values, valid) for a batch of distances under an optional cutoff."""
    raw = np.asarray(raw)
    if cutoff is None:
        return raw, np.ones(raw.shape, bool)
    return raw, raw <= cutoff


def mask_similarity(raw: np.ndarray, cutoff) -> tuple[np.ndarray, np.ndarray]:
    raw = np.asarray(raw)
    if cutoff is None:
        return raw, np.ones(raw.shape, bool)
    return raw, raw >= cutoff
