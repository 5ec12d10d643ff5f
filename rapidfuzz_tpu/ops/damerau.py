"""Batched unrestricted Damerau-Levenshtein kernel.

Semantics of the reference's Zhao-Sahni linear-space algorithm
(``/root/reference/src/distance/damerau_levenshtein.rs:111-168``),
restructured for batched vector hardware: the two sequential
last-occurrence structures become
carried/derived state —

* ``k`` (last row < i whose ``a`` char equals ``b[j]``) is a running
  elementwise max carried across the row scan,
* ``l`` (last column < j in the current row whose ``b`` char equals
  ``a[i]``) is an exclusive running max along the row, computed with an
  associative scan,
* ``FR[j] = D[k-1][j-2]`` is carried state updated at match positions,
* ``t = D[i-2][l-1]`` is a row gather from the i-2 row,

and the within-row left-neighbour dependency ``new[j-1] + 1`` is a
min-plus prefix scan (log depth), as in the weighted Levenshtein kernel.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

BIG = np.int32(1 << 28)   # numpy: keep import free of device ops


def damerau_distance(a, la, b, lb):
    """True unrestricted Damerau-Levenshtein distance -> int32[B].

    All row-shaped state is padded to a multiple of 128 (``RW``) so every
    per-row op, gather, and associative scan works on aligned rows.
    Columns are laid out at index ``j`` (1-based DP
    column ``j`` at lane ``j``); lanes past ``LB`` hold inert values.
    """
    LA = a.shape[-1]
    LB = b.shape[-1]
    RW = max(128, -(-(LB + 1) // 128) * 128)             # padded row width

    B = max(a.shape[0], b.shape[0])
    a_b = jnp.broadcast_to(a, (B, LA))
    b_b = jnp.broadcast_to(b, (B, LB))
    la_b = jnp.broadcast_to(la, (B,))
    lb_b = jnp.broadcast_to(lb, (B,))

    # candidate chars at lane j (1-based); lane 0 and lanes > LB never match
    bpad = jnp.full((B, RW), jnp.int32(-2), jnp.int32)
    bpad = lax.dynamic_update_slice(bpad, jnp.where(b_b < 0, -2, b_b),
                                    (0, 1))

    jj = jnp.arange(RW, dtype=jnp.int32)                 # lane index == j
    row0 = jnp.broadcast_to(jj, (B, RW)).astype(jnp.int32)

    iidx = jnp.arange(1, LA + 1, dtype=jnp.int32)        # 1-based rows

    init = (
        row0,                                            # D_{i-1}[j] at lane j
        jnp.full((B, RW), BIG, jnp.int32),               # D_{i-2}
        jnp.zeros((B, RW), jnp.int32),                   # K: last row matching b[j]
        jnp.full((B, RW), BIG, jnp.int32),               # FR[j] = D[k-1][j-2]
    )

    def step(carry, i):
        dim1, dim2, K, FR = carry
        ai = lax.dynamic_slice_in_dim(a_b, i - 1, 1, axis=1)   # [B, 1]
        eq_i = ai == bpad                                # False at lane 0 / pads
        active = (i <= la_b)

        # (L[j], t[j]) = (last col < j of this row matching a[i],
        #                 D_{i-2}[L-1]) via one last-match propagation scan
        # — a select-scan of 7 log-steps of vector ops instead of a
        # per-element gather
        dim2_up = _shift_up(dim2)                        # D_{i-2}[j-1] at j
        pos0 = jnp.where(eq_i, jj, 0)
        val0 = jnp.where(eq_i, dim2_up, BIG)

        def last_match(x, y):
            xp, xv = x
            yp, yv = y
            take = yp > 0
            return jnp.where(take, yp, xp), jnp.where(take, yv, xv)

        spos, sval = lax.associative_scan(last_match, (pos0, val0), axis=-1)
        L = jnp.where(jj == 0, 0, jnp.roll(spos, 1, -1))
        t = jnp.where(jj == 0, BIG, jnp.roll(sval, 1, -1))
        t = jnp.where(L >= 1, t, BIG)

        diag = _shift_up(dim1)                          # D_{i-1}[j-1]
        cost = jnp.where(eq_i, 0, 1).astype(jnp.int32)
        cand = jnp.minimum(diag + cost, dim1 + 1)
        case1 = jnp.where(jj - L == 1, FR + (i - K), BIG)
        case2 = jnp.where((i - K == 1) & (jj - L != 1), t + (jj - L), BIG)
        tr = jnp.minimum(case1, case2)
        cand = jnp.where(eq_i, cand, jnp.minimum(cand, tr))
        cand = jnp.where(jj == 0, i, cand)               # new[0] = i

        # left-neighbour min-plus prefix: new[j] = min(cand[j], new[j-1]+1)
        new = lax.associative_scan(jnp.minimum, cand - jj, axis=-1) + jj

        # state updates (after the row)
        dim1_m2 = _shift_up(_shift_up(dim1))           # D_{i-1}[j-2]
        FR_new = jnp.where(eq_i, dim1_m2, FR)
        K_new = jnp.maximum(K, jnp.where(eq_i, i, 0))

        sel = active[:, None]
        out = (
            jnp.where(sel, new, dim1),
            jnp.where(sel, dim1, dim2),
            jnp.where(sel, K_new, K),
            jnp.where(sel, FR_new, FR),
        )
        return out, None

    (dfinal, _, _, _), _ = lax.scan(step, init, iidx)
    return jnp.sum(jnp.where(jj == lb_b[:, None], dfinal, 0),
                   axis=-1, dtype=jnp.int32)


def _shift_up(x):
    """Shift lanes up by one (x[j] -> x[j+1]); lane 0 becomes BIG."""
    r = jnp.roll(x, 1, axis=-1)
    lane0 = jnp.arange(x.shape[-1], dtype=jnp.int32) == 0
    return jnp.where(lane0, BIG, r)
