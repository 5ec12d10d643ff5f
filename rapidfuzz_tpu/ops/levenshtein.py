"""Batched uniform/weighted Levenshtein kernels (XLA/jnp compute path).

Device-first redesign of the reference's kernel ladder
(``/root/reference/src/distance/levenshtein.rs``):

* The reference dispatches at runtime between mbleven / 1-word Hyyrö /
  small-band / multi-word banded-block kernels purely for CPU speed — every
  route returns identical scores (``levenshtein.rs:1104-1222``).  Here a
  single *batched* Myers/Hyyrö multi-word recurrence over ``uint32`` lanes
  covers all routes; cutoff semantics are applied by the caller as masks.
* Text position is the sequential axis (``lax.scan``); the (small, static)
  word axis is unrolled; the batch axis is the vector axis.
* Inter-word HP/HN carries follow the block recurrence of
  ``levenshtein.rs:838-875`` (word size 32 instead of 64).

The weighted kernel replaces the reference's Wagner-Fischer row loop
(``levenshtein.rs:212-259``) with a row-parallel formulation: the in-row
``new[i-1] + del`` dependency is a min-plus prefix scan, computed in log
depth with ``lax.associative_scan``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .bitpack import (FULL, ONE, ZERO, pm_columns, test_bit)


def uniform_distance(a: jnp.ndarray, la: jnp.ndarray,
                     b: jnp.ndarray, lb: jnp.ndarray) -> jnp.ndarray:
    """True uniform Levenshtein distance for a batch of padded pairs.

    a: int32[Ba, LA] pattern chars (PAD=-1), la: int32[Ba]
    b: int32[Bb, LB] text chars, lb: int32[Bb]
    Ba/Bb broadcast against each other (one may be 1 for one-vs-many).
    Returns int32[B].
    """
    LA = a.shape[-1]
    W = LA // 32
    assert LA % 32 == 0

    pm = pm_columns(a, b)                       # [B, LB, W]
    B = pm.shape[0]
    la_b = jnp.broadcast_to(la, (B,))
    lb_b = jnp.broadcast_to(lb, (B,))

    last_pos = jnp.maximum(la_b - 1, 0)         # bit index of row m-1

    vp0 = jnp.full((B, W), FULL, jnp.uint32)
    vn0 = jnp.zeros((B, W), jnp.uint32)
    dist0 = la_b.astype(jnp.int32)

    pm_t = jnp.moveaxis(pm, 1, 0)               # [LB, B, W]
    js = jnp.arange(pm_t.shape[0], dtype=jnp.int32)

    def step(carry, inp):
        vp, vn, dist = carry
        pm_j, j = inp
        active = (j < lb_b)

        hp_c = jnp.ones((B,), jnp.uint32)       # '| 1' fed into word 0's shift
        hn_c = jnp.zeros((B,), jnp.uint32)
        hp_words = []
        hn_words = []
        new_vp = []
        new_vn = []
        for w in range(W):
            x = pm_j[:, w] | hn_c
            vpw = vp[:, w]
            vnw = vn[:, w]
            d0 = (((x & vpw) + vpw) ^ vpw) | x | vnw
            hp = vnw | ~(d0 | vpw)
            hn = d0 & vpw
            hp_words.append(hp)
            hn_words.append(hn)
            hp_out = hp >> 31
            hn_out = hn >> 31
            hp_s = (hp << 1) | hp_c
            hn_s = (hn << 1) | hn_c
            new_vp.append(hn_s | ~(d0 | hp_s))
            new_vn.append(hp_s & d0)
            hp_c, hn_c = hp_out, hn_out

        hp_all = jnp.stack(hp_words, axis=-1)   # pre-shift, [B, W]
        hn_all = jnp.stack(hn_words, axis=-1)
        delta = test_bit(hp_all, last_pos) - test_bit(hn_all, last_pos)
        dist = jnp.where(active, dist + delta, dist)

        vp_n = jnp.stack(new_vp, axis=-1)
        vn_n = jnp.stack(new_vn, axis=-1)
        vp = jnp.where(active[:, None], vp_n, vp)
        vn = jnp.where(active[:, None], vn_n, vn)
        return (vp, vn, dist), None

    (_, _, dist), _ = lax.scan(step, (vp0, vn0, dist0), (pm_t, js))
    # empty-pattern edge: distance is just len2
    dist = jnp.where(la_b == 0, lb_b, dist)
    return dist


def uniform_distance_record(a: jnp.ndarray, la: jnp.ndarray,
                            b: jnp.ndarray, lb: jnp.ndarray):
    """Uniform Levenshtein with the per-column (VP, VN) bit-rows recorded.

    Same recurrence as :func:`uniform_distance`, but every text step also
    emits its post-update vertical-delta words, enabling host-side
    alignment traceback (editops/opcodes).  This is the live version of
    the reference's dead ``RECORD_BIT_ROW`` scaffolding
    (``levenshtein.rs:176-210``): cell values reconstruct as

        D[i][j] = j + popcount(VP_j & mask(i)) - popcount(VN_j & mask(i))

    because VP/VN encode the vertical deltas of column j.

    Returns ``(dist[B], vp[LB, B, W], vn[LB, B, W])`` (uint32 words).
    """
    LA = a.shape[-1]
    W = LA // 32
    assert LA % 32 == 0

    pm = pm_columns(a, b)
    B = pm.shape[0]
    la_b = jnp.broadcast_to(la, (B,))
    lb_b = jnp.broadcast_to(lb, (B,))
    last_pos = jnp.maximum(la_b - 1, 0)

    vp0 = jnp.full((B, W), FULL, jnp.uint32)
    vn0 = jnp.zeros((B, W), jnp.uint32)
    dist0 = la_b.astype(jnp.int32)
    pm_t = jnp.moveaxis(pm, 1, 0)
    js = jnp.arange(pm_t.shape[0], dtype=jnp.int32)

    def step(carry, inp):
        vp, vn, dist = carry
        pm_j, j = inp
        active = (j < lb_b)
        hp_c = jnp.ones((B,), jnp.uint32)
        hn_c = jnp.zeros((B,), jnp.uint32)
        hp_words, hn_words, new_vp, new_vn = [], [], [], []
        for w in range(W):
            x = pm_j[:, w] | hn_c
            vpw = vp[:, w]
            vnw = vn[:, w]
            d0 = (((x & vpw) + vpw) ^ vpw) | x | vnw
            hp = vnw | ~(d0 | vpw)
            hn = d0 & vpw
            hp_words.append(hp)
            hn_words.append(hn)
            hp_out = hp >> 31
            hn_out = hn >> 31
            hp_s = (hp << 1) | hp_c
            hn_s = (hn << 1) | hn_c
            new_vp.append(hn_s | ~(d0 | hp_s))
            new_vn.append(hp_s & d0)
            hp_c, hn_c = hp_out, hn_out
        hp_all = jnp.stack(hp_words, axis=-1)
        hn_all = jnp.stack(hn_words, axis=-1)
        delta = test_bit(hp_all, last_pos) - test_bit(hn_all, last_pos)
        dist = jnp.where(active, dist + delta, dist)
        vp = jnp.where(active[:, None], jnp.stack(new_vp, axis=-1), vp)
        vn = jnp.where(active[:, None], jnp.stack(new_vn, axis=-1), vn)
        return (vp, vn, dist), (vp, vn)

    (_, _, dist), (vps, vns) = lax.scan(step, (vp0, vn0, dist0), (pm_t, js))
    dist = jnp.where(la_b == 0, lb_b, dist)
    return dist, vps, vns


def _row_at(row: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """row[..., L] int32 at per-batch idx, gather-free."""
    pos = jnp.arange(row.shape[-1], dtype=jnp.int32)
    return jnp.sum(jnp.where(pos == idx[..., None], row, 0),
                   axis=-1, dtype=jnp.int32)


def weighted_distance(a: jnp.ndarray, la: jnp.ndarray,
                      b: jnp.ndarray, lb: jnp.ndarray,
                      ins: int, dele: int, sub: int) -> jnp.ndarray:
    """Generic weighted Levenshtein (Wagner-Fischer semantics).

    Matches ``generalized_wagner_fischer`` (``levenshtein.rs:212-259``):
    cost of transforming ``a`` into ``b`` where deleting an ``a`` element
    costs ``dele``, inserting a ``b`` element costs ``ins``, substituting
    costs ``sub``.  Weights are static Python ints (part of the jit key).
    Row-parallel: the left-neighbour dependency is a min-plus prefix scan.
    """
    LA = a.shape[-1]
    BIG = jnp.int32(2 ** 30)

    eq = (b[..., :, None] == a[..., None, :]) & (a[..., None, :] >= 0)
    B = eq.shape[0]
    la_b = jnp.broadcast_to(la, (B,))
    lb_b = jnp.broadcast_to(lb, (B,))

    i_idx = jnp.arange(LA + 1, dtype=jnp.int32)          # 0..LA
    row0 = jnp.broadcast_to(i_idx * dele, (B, LA + 1)).astype(jnp.int32)

    eq_t = jnp.moveaxis(eq, 1, 0)                        # [LB, B, LA]
    js = jnp.arange(eq_t.shape[0], dtype=jnp.int32)
    del_ramp = (i_idx * dele).astype(jnp.int32)          # [LA+1]

    def step(old, inp):
        eq_j, j = inp
        active = (j < lb_b)
        # candidate without the left-neighbour term, for i in 1..LA:
        diag = old[:, :-1]                                # old[i-1]
        up = old[:, 1:]                                   # old[i]
        cand = jnp.where(eq_j, diag,
                         jnp.minimum(diag + sub, up + ins)).astype(jnp.int32)
        head = (old[:, :1] + ins)                         # new[0]
        t = jnp.concatenate([head, cand], axis=-1)        # [B, LA+1]
        # new[i] = min_{k<=i} t[k] + dele*(i-k)
        shifted = t - del_ramp
        pmin = lax.associative_scan(jnp.minimum, shifted, axis=-1)
        new = pmin + del_ramp
        new = jnp.where(active[:, None], new, old)
        return new, None

    row, _ = lax.scan(step, row0, (eq_t, js))
    return _row_at(row, la_b)
