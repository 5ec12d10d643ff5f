"""Edit operations (editops / opcodes / matching blocks).

The reference crate carries only dead recording scaffolding for this
(``/root/reference/src/distance/levenshtein.rs:176-210`` — the
``RECORD_MATRIX``/``RECORD_BIT_ROW`` const generics are only ever
instantiated ``<0, 0>``); the wider rapidfuzz ecosystem (rapidfuzz-cpp /
rapidfuzz-py) exposes the full alignment API.  This module provides the
device-native version:

* the device kernels record per-text-column bit-rows
  (``ops/levenshtein.py:uniform_distance_record`` /
  ``ops/lcs.py:lcs_record``) — O(len1·len2 / 8) bytes, the same
  asymptotics as the ecosystem's bit-matrix recorders;
* the host walks the recorded rows backwards, reconstructing DP cells
  with masked popcounts:

      Levenshtein:  D[i][j] = j + popcnt(VP_j & mask(i))
                                 - popcnt(VN_j & mask(i))
      LCS:          L[i][j] = popcnt(~S_j & mask(i))

Conventions match rapidfuzz: an ``Editop`` is ``(tag, src_pos, dest_pos)``
with tag in {"replace", "insert", "delete"}; ``src_pos``/``dest_pos`` are
the positions of the affected elements ("insert" carries the *current*
source position where the destination element is inserted).  ``Opcodes``
are difflib-style ``(tag, src_start, src_end, dest_start, dest_end)``
including "equal" runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Sequence

import numpy as np

from ..ops import dispatch as _dispatch
from ..utils import codec as _codec

__all__ = ["Editop", "Editops", "Opcode", "Opcodes", "MatchingBlock",
           "levenshtein_editops", "lcs_editops", "indel_editops",
           "levenshtein_editops_many", "lcs_editops_many",
           "indel_editops_many"]

#: Recording a pair needs 2 * ceil(len1/32) * len2 words; refuse beyond
#: this many bytes (~16k x 16k chars) instead of silently thrashing.
_MAX_RECORD_BYTES = 1 << 29


# ---------------------------------------------------------------- containers

@dataclass(frozen=True)
class Editop:
    tag: str            # "replace" | "insert" | "delete"
    src_pos: int
    dest_pos: int


@dataclass(frozen=True)
class Opcode:
    tag: str            # "replace" | "insert" | "delete" | "equal"
    src_start: int
    src_end: int
    dest_start: int
    dest_end: int


@dataclass(frozen=True)
class MatchingBlock:
    a: int
    b: int
    size: int


class Editops:
    """A minimal edit script transforming ``src`` into ``dest``."""

    def __init__(self, ops: Sequence[Editop], src_len: int, dest_len: int):
        self._ops = list(ops)
        self.src_len = src_len
        self.dest_len = dest_len

    def __len__(self) -> int:
        return len(self._ops)

    def __iter__(self) -> Iterator[Editop]:
        return iter(self._ops)

    def __getitem__(self, i):
        return self._ops[i]

    def __eq__(self, other):
        return (isinstance(other, Editops) and self._ops == other._ops
                and self.src_len == other.src_len
                and self.dest_len == other.dest_len)

    def __repr__(self):
        return f"Editops({self._ops!r}, {self.src_len}, {self.dest_len})"

    def inverse(self) -> "Editops":
        """The script transforming ``dest`` back into ``src``."""
        swap = {"insert": "delete", "delete": "insert", "replace": "replace"}
        return Editops([Editop(swap[o.tag], o.dest_pos, o.src_pos)
                        for o in self._ops], self.dest_len, self.src_len)

    def as_list(self) -> List[tuple]:
        """``[(tag, src_pos, dest_pos), ...]`` (rapidfuzz-py compat)."""
        return [(o.tag, o.src_pos, o.dest_pos) for o in self._ops]

    def as_opcodes(self) -> "Opcodes":
        ops = []
        i = j = 0
        k = 0
        n = len(self._ops)
        while k < n:
            op = self._ops[k]
            if op.src_pos > i or op.dest_pos > j:
                ops.append(Opcode("equal", i, op.src_pos, j, op.dest_pos))
                i, j = op.src_pos, op.dest_pos
            si, sj = i, j
            tag = op.tag
            while (k < n and self._ops[k].tag == tag
                   and self._ops[k].src_pos == i
                   and self._ops[k].dest_pos == j):
                if tag != "insert":
                    i += 1
                if tag != "delete":
                    j += 1
                k += 1
            ops.append(Opcode(tag, si, i, sj, j))
        if i < self.src_len or j < self.dest_len:
            ops.append(Opcode("equal", i, self.src_len, j, self.dest_len))
        return Opcodes(ops, self.src_len, self.dest_len)

    def as_matching_blocks(self) -> List[MatchingBlock]:
        blocks = [MatchingBlock(o.src_start, o.dest_start,
                                o.src_end - o.src_start)
                  for o in self.as_opcodes() if o.tag == "equal"]
        blocks.append(MatchingBlock(self.src_len, self.dest_len, 0))
        return blocks

    def apply(self, s1, s2):
        """Replay the script on ``s1``, taking inserted/replaced elements
        from ``s2`` — returns the reconstructed destination (the element
        type of ``s2``: str stays str, otherwise a list)."""
        e1 = list(s1) if not isinstance(s1, np.ndarray) else list(s1)
        e2 = list(s2) if not isinstance(s2, np.ndarray) else list(s2)
        out = []
        i = 0
        for op in self._ops:
            out.extend(e1[i:op.src_pos])
            i = op.src_pos
            if op.tag == "delete":
                i += 1
            elif op.tag == "insert":
                out.append(e2[op.dest_pos])
            else:                               # replace
                out.append(e2[op.dest_pos])
                i += 1
        out.extend(e1[i:])
        if isinstance(s2, str):
            return "".join(out)
        return out


class Opcodes:
    """difflib-style grouped edit operations (including "equal" runs)."""

    def __init__(self, ops: Sequence[Opcode], src_len: int, dest_len: int):
        self._ops = list(ops)
        self.src_len = src_len
        self.dest_len = dest_len

    def __len__(self) -> int:
        return len(self._ops)

    def __iter__(self) -> Iterator[Opcode]:
        return iter(self._ops)

    def __getitem__(self, i):
        return self._ops[i]

    def __eq__(self, other):
        return (isinstance(other, Opcodes) and self._ops == other._ops
                and self.src_len == other.src_len
                and self.dest_len == other.dest_len)

    def __repr__(self):
        return f"Opcodes({self._ops!r}, {self.src_len}, {self.dest_len})"

    def as_list(self) -> List[tuple]:
        """``[(tag, src_start, src_end, dest_start, dest_end), ...]``
        (rapidfuzz-py compat)."""
        return [(o.tag, o.src_start, o.src_end, o.dest_start, o.dest_end)
                for o in self._ops]

    def as_editops(self) -> Editops:
        ops = []
        for o in self._ops:
            if o.tag == "replace":
                for k in range(o.src_end - o.src_start):
                    ops.append(Editop("replace", o.src_start + k,
                                      o.dest_start + k))
            elif o.tag == "delete":
                for k in range(o.src_end - o.src_start):
                    ops.append(Editop("delete", o.src_start + k, o.dest_start))
            elif o.tag == "insert":
                for k in range(o.dest_end - o.dest_start):
                    ops.append(Editop("insert", o.src_start, o.dest_start + k))
        return Editops(ops, self.src_len, self.dest_len)


# ---------------------------------------------------------------- primitives

def _popcount(words: np.ndarray) -> int:
    return int(np.unpackbits(words.view(np.uint8)).sum())


def _masked_pop(words: np.ndarray, i: int) -> int:
    """popcount of the lowest ``i`` bits of a little-endian u32 word row."""
    if i <= 0:
        return 0
    full, rem = divmod(i, 32)
    total = _popcount(words[:full]) if full else 0
    if rem:
        total += _popcount(words[full:full + 1]
                           & np.uint32((1 << rem) - 1))
    return total


def _bit(words: np.ndarray, k: int) -> bool:
    return bool((int(words[k // 32]) >> (k % 32)) & 1)


def _record_pair(record_fn, u1: np.ndarray, u2: np.ndarray):
    """Run a recording kernel on one encoded pair -> numpy outputs."""
    c1, l1, c2, l2 = _codec.encode_pair_batch([u1], [u2])
    w_bytes = 2 * (c1.shape[-1] // 32) * c2.shape[-1] * 4
    if w_bytes > _MAX_RECORD_BYTES:
        raise ValueError(
            f"editops recording for lengths {u1.size} x {u2.size} needs "
            f"{w_bytes >> 20} MiB of bit-rows (cap "
            f"{_MAX_RECORD_BYTES >> 20} MiB)")
    import jax
    fn = _dispatch.jit_kernel(record_fn)
    out = fn(c1, l1, c2, l2)
    return [np.asarray(jax.device_get(o)) for o in out]


# ---------------------------------------------------------- lev traceback

def levenshtein_editops(s1, s2) -> Editops:
    """Minimal uniform-Levenshtein edit script for one pair.

    The distance itself comes from the recorded device run and equals
    ``len(result)``; the traceback prefers diagonal moves (match, then
    replace), then delete, then insert — every returned script is minimal
    and ``apply`` reconstructs ``s2`` exactly (tested properties).
    """
    u1, u2 = _codec.encode_one(s1), _codec.encode_one(s2)
    m, n = int(u1.size), int(u2.size)
    if m == 0:
        return Editops([Editop("insert", 0, j) for j in range(n)], m, n)
    if n == 0:
        return Editops([Editop("delete", i, 0) for i in range(m)], m, n)

    from ..ops import levenshtein as _lev_ops
    dist, vps, vns = _record_pair(_lev_ops.uniform_distance_record, u1, u2)
    return _lev_traceback(u1, u2, vps[:, 0], vns[:, 0], int(dist[0]))


def _lev_traceback(u1: np.ndarray, u2: np.ndarray, vps: np.ndarray,
                   vns: np.ndarray, d: int) -> Editops:
    """Walk recorded (VP, VN) bit-rows ([LB, W]) back into an edit script."""
    m, n = int(u1.size), int(u2.size)

    def cell(i: int, j: int) -> int:
        if j == 0:
            return i
        return j + _masked_pop(vps[j - 1], i) - _masked_pop(vns[j - 1], i)

    ops: List[Editop] = []
    i, j = m, n
    cur = d
    while i > 0 and j > 0:
        diag = cell(i - 1, j - 1)
        if u1[i - 1] == u2[j - 1] and diag == cur:
            i -= 1
            j -= 1
        elif diag == cur - 1:
            ops.append(Editop("replace", i - 1, j - 1))
            i -= 1
            j -= 1
            cur -= 1
        elif _bit(vps[j - 1], i - 1):           # D[i-1][j] == cur - 1
            ops.append(Editop("delete", i - 1, j))
            i -= 1
            cur -= 1
        else:                                   # insertion must be optimal
            ops.append(Editop("insert", i, j - 1))
            j -= 1
            cur -= 1
    while i > 0:
        ops.append(Editop("delete", i - 1, 0))
        i -= 1
        cur -= 1
    while j > 0:
        ops.append(Editop("insert", 0, j - 1))
        j -= 1
        cur -= 1
    assert cur == 0, "traceback did not consume the full distance"
    ops.reverse()
    return Editops(ops, m, n)


# ---------------------------------------------------------- lcs traceback

def lcs_editops(s1, s2) -> Editops:
    """Insert/delete-only edit script from the LCS alignment.

    ``len(result) == indel distance``; shared by ``lcs_seq.editops`` and
    ``indel.editops`` (the two metrics share the alignment, they only
    score it differently — ``indel.rs:62-104``).
    """
    u1, u2 = _codec.encode_one(s1), _codec.encode_one(s2)
    m, n = int(u1.size), int(u2.size)
    if m == 0:
        return Editops([Editop("insert", 0, j) for j in range(n)], m, n)
    if n == 0:
        return Editops([Editop("delete", i, 0) for i in range(m)], m, n)

    from ..ops import lcs as _lcs_ops
    _, rows = _record_pair(_lcs_ops.lcs_record, u1, u2)
    return _lcs_traceback(u1, u2, rows[:, 0])


def _lcs_traceback(u1: np.ndarray, u2: np.ndarray,
                   rows: np.ndarray) -> Editops:
    """Walk recorded ``S`` bit-rows ([LB, W]) back into an indel script."""
    m, n = int(u1.size), int(u2.size)

    def lcell(i: int, j: int) -> int:
        if j == 0 or i == 0:
            return 0
        return i - _masked_pop(rows[j - 1], i)

    ops: List[Editop] = []
    i, j = m, n
    cur = lcell(m, n)
    while i > 0 and j > 0:
        if u1[i - 1] == u2[j - 1] and lcell(i - 1, j - 1) == cur - 1:
            i -= 1
            j -= 1
            cur -= 1
        elif lcell(i - 1, j) == cur:
            ops.append(Editop("delete", i - 1, j))
            i -= 1
        else:
            ops.append(Editop("insert", i, j - 1))
            j -= 1
    while i > 0:
        ops.append(Editop("delete", i - 1, 0))
        i -= 1
    while j > 0:
        ops.append(Editop("insert", 0, j - 1))
        j -= 1
    ops.reverse()
    return Editops(ops, m, n)


indel_editops = lcs_editops


# ------------------------------------------------------------ batch forms

def _trivial_ops(m: int, n: int) -> Editops:
    if m == 0:
        return Editops([Editop("insert", 0, j) for j in range(n)], m, n)
    return Editops([Editop("delete", i, 0) for i in range(m)], m, n)


def _record_many(record_fn, s1, choices):
    """One recording dispatch over a whole candidate batch.

    The recording kernels are natively batched over candidates
    (``uniform_distance_record`` returns ``[LB, B, W]`` rows), so a
    one-vs-many alignment scan is a single device call: the query is
    replicated along the batch axis, the candidates padded into one
    bucket.  Returns ``(u1, us2, outs)`` where ``outs`` are numpy kernel
    outputs; candidates are NOT reordered.
    """
    u1 = _codec.encode_one(s1)
    us2 = [_codec.encode_one(c) for c in choices]
    nz = [i for i, u in enumerate(us2) if u.size]
    if u1.size == 0 or not nz:
        return u1, us2, None
    import jax
    sub = [choices[i] for i in nz]
    c1, l1, c2, l2 = _codec.encode_pair_batch([s1] * len(sub), sub)
    w_bytes = 2 * (c1.shape[-1] // 32) * c2.shape[-1] * len(sub) * 4
    if w_bytes > _MAX_RECORD_BYTES:
        raise ValueError(
            f"editops recording for {len(sub)} candidates of bucket "
            f"{c2.shape[-1]} x query {u1.size} needs {w_bytes >> 20} MiB "
            f"of bit-rows (cap {_MAX_RECORD_BYTES >> 20} MiB); batch fewer "
            "candidates")
    fn = _dispatch.jit_kernel(record_fn)
    out = fn(c1, l1, c2, l2)
    outs = [np.asarray(jax.device_get(o)) for o in out]
    return u1, us2, (nz, outs)


def levenshtein_editops_many(s1, choices) -> List[Editops]:
    """Minimal edit scripts from ``s1`` to every choice, one device scan.

    Equivalent to ``[levenshtein_editops(s1, c) for c in choices]`` but
    the bit-row recording runs as a single batched dispatch (the
    one-vs-many analogue of the pair recording kernel); only the
    traceback is per-hit host work.
    """
    from ..ops import levenshtein as _lev_ops
    u1, us2, rec = _record_many(_lev_ops.uniform_distance_record, s1, choices)
    out: List[Editops] = [None] * len(us2)
    for i, u2 in enumerate(us2):
        if u1.size == 0 or u2.size == 0:
            out[i] = _trivial_ops(int(u1.size), int(u2.size))
    if rec is not None:
        nz, (dist, vps, vns) = rec
        for bi, i in enumerate(nz):
            out[i] = _lev_traceback(u1, us2[i], vps[:, bi], vns[:, bi],
                                    int(dist[bi]))
    return out


def lcs_editops_many(s1, choices) -> List[Editops]:
    """Indel/LCS edit scripts from ``s1`` to every choice, one device scan
    (see :func:`levenshtein_editops_many`)."""
    from ..ops import lcs as _lcs_ops
    u1, us2, rec = _record_many(_lcs_ops.lcs_record, s1, choices)
    out: List[Editops] = [None] * len(us2)
    for i, u2 in enumerate(us2):
        if u1.size == 0 or u2.size == 0:
            out[i] = _trivial_ops(int(u1.size), int(u2.size))
    if rec is not None:
        nz, (_, rows) = rec
        for bi, i in enumerate(nz):
            out[i] = _lcs_traceback(u1, us2[i], rows[:, bi])
    return out


indel_editops_many = lcs_editops_many
