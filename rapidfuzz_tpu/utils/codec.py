"""Host-side string/sequence encoding for the device kernels.

The reference library is generic over ``Iterator<Item: HashableChar>``
(``/root/reference/src/lib.rs:146-148``): inputs may be ``.chars()``,
``.bytes()``, integer slices, or user types, and only *equality* of elements
matters for every metric.  The device-native equivalent canonicalises every
input into a padded ``int32`` array:

* ``str``      -> unicode codepoints (max 0x10FFFF < 2**31, exact)
* ``bytes``    -> byte values 0..255
* int sequence -> values used directly when they fit ``int32``; otherwise the
  batch is remapped through a dense shared vocabulary (equality-preserving,
  mirroring the role of the reference's overflow hashmaps in
  ``src/details/pattern_match_vector.rs:104-154``).

Padding uses ``PAD = -1`` which never equals a real element, so padded
positions can never produce a character match (SURVEY.md hard part #5).
"""

from __future__ import annotations

import numpy as np
from typing import Iterable, Sequence

PAD = np.int32(-1)

#: Length buckets used to bound the number of compiled kernel variants.
#: Multiples of 32 (the lane word size); doubles after 512.
_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512, 1024, 2048, 4096, 8192,
            16384, 32768, 65536, 131072)


def bucket_len(n: int) -> int:
    """Smallest bucket >= n (>= 32 so W >= 1)."""
    for b in _BUCKETS:
        if n <= b:
            return b
    # beyond the table: round up to a multiple of 32768
    return int(-(-n // 32768) * 32768)


# Interning for the element domain the reference spans with its Hash enum
# (i64::MIN ..= u64::MAX, lib.rs:102-120): 2^65 values cannot embed in the
# int64 code space, so the two ambiguous ranges — negative i64 and
# u64 > i64::MAX — are interned into a process-global table allocating
# distinct negative codes (downward from -2; -1 is PAD).  Equality then
# holds exactly iff the reference's Hash equality holds, across all calls
# in the process.
_INTERN: dict = {}
_INTERN_NEXT = [-2]


def _intern_codes(tag: str, values) -> np.ndarray:
    out = np.empty(len(values), np.int64)
    nxt = _INTERN_NEXT
    for i, v in enumerate(values):
        key = (tag, int(v))
        code = _INTERN.get(key)
        if code is None:
            code = _INTERN[key] = nxt[0]
            nxt[0] -= 1
        out[i] = code
    return out


def encode_one(s) -> np.ndarray:
    """Encode a single string/bytes/sequence to an int-valued numpy array.

    Returns int64 so that arbitrary integer inputs survive; callers narrow to
    int32 (possibly via vocab remap) when building device batches.  Codes are
    >= 0 except interned carriers (see :func:`_intern_codes`), which go
    through the vocab remap like any negative value.
    """
    if isinstance(s, str):
        if not s:
            return np.empty(0, np.int64)
        return np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32).astype(np.int64)
    if isinstance(s, (bytes, bytearray)):
        return np.frombuffer(bytes(s), dtype=np.uint8).astype(np.int64)
    if isinstance(s, np.ndarray):
        if s.dtype == np.uint64:
            hi = s > np.uint64(np.iinfo(np.int64).max)
            if hi.any():
                out = s.view(np.int64).copy()
                out[hi] = _intern_codes("u", s[hi])
                return out
            return s.astype(np.int64)
        out = s.astype(np.int64)
        neg = out < 0
        if neg.any():
            out = out.copy()
            out[neg] = _intern_codes("i", out[neg])
        return out
    seq = list(s)
    if not seq:
        return np.empty(0, np.int64)
    lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    vals = [int(v) for v in seq]
    if any(v < lo or v > 2 ** 64 - 1 for v in vals):
        raise OverflowError("element outside the i64..u64 Hash domain")
    out = np.empty(len(vals), np.int64)
    for i, v in enumerate(vals):
        if 0 <= v <= hi:
            out[i] = v
        elif v < 0:
            out[i] = _intern_codes("i", [v])[0]
        else:                                   # i64::MAX < v <= u64::MAX
            out[i] = _intern_codes("u", [v])[0]
    return out


def _needs_remap(arrs: Sequence[np.ndarray]) -> bool:
    hi = np.iinfo(np.int32).max
    for a in arrs:
        # negative values collide with PAD; remap them too
        if a.size and (a.min() < 0 or a.max() > hi):
            return True
    return False


def remap_to_vocab(arrs: Sequence[np.ndarray]) -> list[np.ndarray]:
    """Dense equality-preserving remap of a group of int64 arrays to int32 ids."""
    if not arrs:
        return []
    flat = np.concatenate([a for a in arrs]) if any(a.size for a in arrs) else np.empty(0, np.int64)
    vocab = np.unique(flat)
    out = []
    for a in arrs:
        ids = np.searchsorted(vocab, a).astype(np.int32) if a.size else np.empty(0, np.int32)
        out.append(ids)
    return out


def _scatter_pad(flat: np.ndarray, lens: np.ndarray,
                 bucket: int | None) -> tuple[np.ndarray, np.ndarray]:
    """Scatter concatenated elements into a PAD-filled ``[B, L]`` matrix.

    ``flat`` holds every element back-to-back, ``lens`` the per-row
    counts; one fancy-index write replaces the per-row Python loop that
    dominated large-corpus ingestion.  Shared by :func:`pad_batch` and
    :func:`encode_batch`'s str fast path — the two ingestion routes must
    stay byte-identical (CorpusScanner fingerprints the output).
    """
    lens = lens.astype(np.int32)
    B = len(lens)
    maxlen = int(lens.max()) if B else 0
    L = bucket if bucket is not None else bucket_len(max(maxlen, 1))
    if maxlen > L:
        raise ValueError(f"bucket {L} too small for max length {maxlen}")
    out = np.full((B, L), PAD, np.int32)
    if maxlen:
        l64 = lens.astype(np.int64)
        rows = np.repeat(np.arange(B, dtype=np.int64), l64)
        ends = np.cumsum(l64)
        cols = np.arange(flat.size, dtype=np.int64) - np.repeat(
            ends - l64, l64)
        out[rows, cols] = flat.astype(np.int32, copy=False)
    return out, lens


def pad_batch(arrs: Sequence[np.ndarray], bucket: int | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Pad a group of int arrays into ``(chars[B, L], lens[B])`` int32.

    Elements outside int32 (or negative) are remapped through a shared
    vocabulary first, preserving equality within the batch.
    """
    arrs = [np.asarray(a, np.int64) for a in arrs]
    if _needs_remap(arrs):
        arrs32 = remap_to_vocab(arrs)
    else:
        arrs32 = [a.astype(np.int32) for a in arrs]
    lens = np.fromiter((a.size for a in arrs32), np.int32,
                       count=len(arrs32))
    flat = (np.concatenate(arrs32) if arrs32
            else np.empty(0, np.int32))
    return _scatter_pad(flat, lens, bucket)


def encode_batch(seqs: Iterable, bucket: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Encode+pad a batch of strings/sequences -> (chars[B, L], lens[B]).

    All-``str`` batches take a vectorized path: one joined utf-32 encode
    plus a single scatter (the per-string loop costs ~7 s per 1M strings;
    this path is ~20x faster — corpus ingestion for CorpusScanner/serve).
    """
    seqs = seqs if isinstance(seqs, list) else list(seqs)
    if seqs and all(type(s) is str for s in seqs):
        lens = np.fromiter((len(s) for s in seqs), np.int32,
                           count=len(seqs))
        joined = "".join(seqs)
        # codepoints are < 0x110000, always inside int32: no remap path
        flat = (np.frombuffer(joined.encode("utf-32-le"), dtype=np.uint32)
                .astype(np.int32) if joined else np.empty(0, np.int32))
        return _scatter_pad(flat, lens, bucket)
    arrs = [encode_one(s) for s in seqs]
    return pad_batch(arrs, bucket)


def encode_pair_batch(seqs1: Iterable, seqs2: Iterable,
                      bucket1: int | None = None, bucket2: int | None = None):
    """Encode two aligned groups with a *shared* vocabulary when remapping.

    Cross-group equality must be preserved (queries vs candidates), so the
    vocab is built over the union.
    """
    a1 = [encode_one(s) for s in seqs1]
    a2 = [encode_one(s) for s in seqs2]
    if _needs_remap(a1 + a2):
        remapped = remap_to_vocab(a1 + a2)
        a1, a2 = remapped[: len(a1)], remapped[len(a1):]
    c1, l1 = pad_batch(a1, bucket1)
    c2, l2 = pad_batch(a2, bucket2)
    return c1, l1, c2, l2
