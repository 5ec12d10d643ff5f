"""Pallas kernels (Triton route) for one-vs-many and grouped corpus scans.

Uniform Levenshtein (Myers/Hyyrö, ``levenshtein.rs:466-490`` and the
multi-word block recurrence of ``levenshtein.rs:838-875``) and LCS length
(Hyyrö, ``lcs_seq.rs:199-261``; serves indel, lcs_seq and fuzz.ratio) over a
byte-packed, device-resident corpus.

Layout and work split:

* one candidate per thread; a program holds :data:`BLOCK` candidates and
  keeps each one's ``W = ceil(la/32)`` u32 state words in registers for the
  whole text loop (the XLA route carries them through device memory at
  every step of a ``lax.scan``);
* the corpus is byte-packed column-major, ``[LB/4, B]`` u32: text position
  ``j`` of candidate ``b`` is byte ``j % 4`` of word ``[j // 4, b]``, so a
  warp's load at each step is contiguous;
* the query's pattern-match table (the reference's ``PatternMatchVector``,
  ``pattern_match_vector.rs:67-155``) is a ``[rows + 1, W]`` u32 table read
  with a gather load; it is a few KB and stays in L1.  Row ``rows`` is all
  zero: LCS steps past a candidate's length read it, which leaves the state
  unchanged, so the LCS body needs no per-word masking;
* a program serves ``G`` queries of one word bucket at once and reuses each
  loaded text word across them (the grouped ``scan_many`` form);
* the text loop runs to the longest candidate of the block; the scanner
  length-sorts the corpus so a block's trip counts stay close.

Word carries are u32 with the explicit carry chain of the reference's
``carrying_add`` (``intrinsics.rs:25-29``), which Pallas expresses without
64-bit mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: candidates per program (one per thread at 4 warps)
BLOCK = 128
NUM_WARPS = 4
#: run the kernel in Pallas' interpreter (the CPU test suite sets it; it
#: has no other use)
INTERPRET = False


def table_rows(mode: str) -> int:
    """PM table rows for a pick_mode result: every char of the query and
    the corpus is below this bound."""
    return 128 if mode == "local" else 256


def pick_mode(query: np.ndarray, corpus_max: int) -> str:
    """'local' (128-row table) when every char < 128, else 'byte'."""
    q = np.asarray(query)
    qmax = int(q.max()) if q.size else 0
    return "local" if max(qmax, corpus_max) < 128 else "byte"


def n_words(la: int) -> int:
    return max(1, -(-int(la) // 32))


def build_pm_table(query: np.ndarray, rows: int, W: int) -> np.ndarray:
    """Host PM table ``[rows + 1, W]`` u32 (``BatchComparator::new``,
    ``levenshtein.rs:1645-1657``): bit ``i % 32`` of word ``i // 32`` in
    row ``c`` is set iff ``query[i] == c``; row ``rows`` stays zero."""
    q = np.asarray(query, np.int64)
    pm = np.zeros((rows + 1, W), np.uint32)
    pos = np.nonzero((q >= 0) & (q < rows))[0]
    if pos.size:                       # ufunc.at ORs duplicates correctly
        np.bitwise_or.at(pm, (q[pos], pos >> 5),
                         np.uint32(1) << (pos & 31).astype(np.uint32))
    return pm


@functools.partial(jax.jit, static_argnames=("LB",))
def prepare_corpus(chars: jnp.ndarray, *, LB: int) -> jnp.ndarray:
    """[B, LB] i32 byte corpus -> [LB/4, B] u32 byte-packed columns.

    Padding (negative) chars pack as 0; the kernels never read them
    unmasked.
    """
    B = chars.shape[0]
    u8 = jnp.where(chars < 0, 0, chars).astype(jnp.uint32)
    u8 = u8.reshape(B, LB // 4, 4)
    packed = (u8[..., 0] | (u8[..., 1] << 8) | (u8[..., 2] << 16)
              | (u8[..., 3] << 24))
    return jnp.transpose(packed, (1, 0))


def _popcount(x):
    """SWAR popcount of u32 lanes -> i32 (Triton has no lowering for
    ``lax.population_count``)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24).astype(jnp.int32)


def _kernel(la_ref, tab_ref, cand_ref, lb_ref, out_ref, *, lcs: bool,
            W: int, rows: int, G: int, block: int):
    qg = pl.program_id(0)
    cols = pl.ds(pl.program_id(1) * block, block)
    lb = lb_ref[cols]
    tw = (rows + 1) * W                 # table words per query
    bases = [(qg * G + g) * tw for g in range(G)]

    def step(row, u, j, state, masked):
        c = ((row >> (8 * u)) & 0xFF).astype(jnp.int32) if u else \
            (row & 0xFF).astype(jnp.int32)
        if lcs and masked:
            c = jnp.where(j < lb, c, rows)
        cw = c * W
        out = []
        for g in range(G):
            words = state[g]
            pm = [tab_ref[cw + (bases[g] + w)] for w in range(W)]
            if lcs:
                carry = None
                new = []
                for w in range(W):
                    sw = words[w]
                    um = sw & pm[w]
                    x1 = sw + um
                    x2 = x1 if carry is None else x1 + carry
                    if w != W - 1:
                        c1 = (x1 < sw).astype(jnp.uint32)
                        carry = (c1 if carry is None
                                 else c1 | (x2 < x1).astype(jnp.uint32))
                    new.append(x2 | (sw - um))
                out.append(tuple(new))
                continue
            dist, last_bit = words[0], words[1]
            vp, vn = words[2:2 + W], words[2 + W:]
            hp_c = jnp.ones_like(lb).astype(jnp.uint32)
            hn_c = jnp.zeros_like(hp_c)
            nvp, nvn = [], []
            delta = None
            for w in range(W):
                x = pm[w] | hn_c
                vpw, vnw = vp[w], vn[w]
                d0 = (((x & vpw) + vpw) ^ vpw) | x | vnw
                hp = vnw | ~(d0 | vpw)
                hn = d0 & vpw
                if w == W - 1:
                    delta = (((hp >> last_bit) & 1).astype(jnp.int32)
                             - ((hn >> last_bit) & 1).astype(jnp.int32))
                hp_s = (hp << 1) | hp_c
                hn_s = (hn << 1) | hn_c
                nvp.append(hn_s | ~(d0 | hp_s))
                nvn.append(hp_s & d0)
                hp_c, hn_c = hp >> 31, hn >> 31
            dist = (jnp.where(j < lb, dist + delta, dist) if masked
                    else dist + delta)
            out.append((dist, last_bit, *nvp, *nvn))
        return out

    def make_body(masked):
        def body(jj, state):
            row = cand_ref[jj, cols]
            for u in range(4):
                state = step(row, u, jj * 4 + u, state, masked)
            return state
        return body

    ones = jnp.full((block,), 0xFFFFFFFF, jnp.uint32)
    zeros = jnp.zeros((block,), jnp.uint32)
    if lcs:
        state = [(ones,) * W for _ in range(G)]
    else:
        state = []
        for g in range(G):
            la = la_ref[qg * G + g]
            dist0 = jnp.full((block,), la, jnp.int32)
            last_bit = ((la - 1) & 31).astype(jnp.uint32)
            state.append((dist0, last_bit) + (ones,) * W + (zeros,) * W)
    full = jnp.min(lb) // 4
    trips = (jnp.max(lb) + 3) // 4
    state = lax.fori_loop(0, full, make_body(False), state)
    state = lax.fori_loop(full, trips, make_body(True), state)
    for g in range(G):
        q = qg * G + g
        if lcs:
            res = jnp.zeros((block,), jnp.int32)
            for w in range(W):
                res = res + _popcount(~state[g][w])
        else:
            res = jnp.where(la_ref[q] == 0, lb, state[g][0])
        out_ref[q, cols] = res


@functools.partial(jax.jit, static_argnames=("lcs", "W", "rows", "G",
                                             "interpret"))
def _run(las, tabs, cand, lens, *, lcs, W, rows, G, interpret):
    NQ = las.shape[0]
    B = cand.shape[1]
    assert NQ % G == 0 and B % BLOCK == 0, (NQ, G, B)
    kern = functools.partial(_kernel, lcs=lcs, W=W, rows=rows, G=G,
                             block=BLOCK)
    return pl.pallas_call(
        kern,
        grid=(NQ // G, B // BLOCK),
        out_shape=jax.ShapeDtypeStruct((NQ, B), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="lcs_scan" if lcs else "lev_scan",
    )(las, tabs, cand, lens)


def run(las, tabs, cand, lens, *, lcs: bool, W: int, rows: int,
        G: int = 1) -> jnp.ndarray:
    """Scan NQ queries (``las`` [NQ] i32 lengths, ``tabs`` their stacked
    tables from :func:`stage_queries`) over the packed corpus ``cand``
    [LB/4, B] with lengths ``lens`` [B] -> [NQ, B] i32: Levenshtein
    distances, or LCS lengths with ``lcs``.  ``G`` queries share each
    program (``NQ % G == 0``); ``B`` is a multiple of :data:`BLOCK`."""
    return _run(las, tabs, cand, lens, lcs=lcs, W=W, rows=rows, G=G,
                interpret=INTERPRET)


def stage_queries(queries, rows: int, W: int):
    """Host arrays of NQ queries' lengths and stacked PM tables for
    :func:`run`: ``(las [NQ] i32, tabs [NQ * (rows + 1) * W] u32)``."""
    qs = [np.asarray(q) for q in queries]
    las = np.array([q.size for q in qs], np.int32)
    tabs = np.concatenate([build_pm_table(q, rows, W).reshape(-1)
                           for q in qs])
    return las, tabs


def scan(metric: str, queries, cand, lens, *, mode: str,
         group: int = 1) -> jnp.ndarray:
    """Levenshtein distances (``metric="levenshtein"``) or LCS lengths
    (``"lcs"``) of each query against every packed candidate -> [NQ, B].

    All queries must share one word bucket; ``len(queries)`` must be a
    multiple of ``group``.
    """
    Ws = {n_words(np.asarray(q).size) for q in queries}
    if len(Ws) != 1:
        raise ValueError(f"queries span word buckets {sorted(Ws)}")
    W = Ws.pop()
    rows = table_rows(mode)
    las, tabs = stage_queries(queries, rows, W)
    return run(las, tabs, cand, lens, lcs=metric != "levenshtein", W=W,
               rows=rows, G=group)
