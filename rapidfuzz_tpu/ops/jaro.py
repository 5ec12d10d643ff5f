"""Batched Jaro flagging kernel (integer components).

Replicates the reference's exact match-assignment semantics
(``/root/reference/src/distance/jaro.rs:422-514``):

* window bound from the longer string (``maxlen/2 - 1``), the longer string
  truncated to ``shorter + bound`` (``jaro.rs:457-470``),
* common prefix counted without transpositions (``jaro.rs:475-479``),
* greedy flagging: per text char, claim the *lowest unflagged* matching
  pattern position inside the moving window (``jaro.rs:147-190`` — the
  ``blsi`` lowest-set-bit claim).  This loop-carried dependency stays on
  the text axis as a ``lax.scan`` with the claimed mask as carried state
  (SURVEY.md hard part #2); the lowest-bit claim becomes an argmax over the
  pattern axis (first True wins),
* transpositions: rank-matched flagged chars that differ
  (``jaro.rs:339-368``), computed as a post-pass with a stable argsort
  compaction.

The kernel returns integer ``(common_chars, mismatched_pairs)`` so the
final f64 similarity (``jaro.rs:106-119``) is computed host-side in exact
double precision — device f32 would violate the ULP conformance target.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def jaro_components(a, la, b, lb):
    """(common_chars int32[B], mismatched_flag_pairs int32[B]).

    ``common_chars`` includes the prefix; ``mismatched_flag_pairs`` is the
    raw count before the ``/2`` of ``calculate_similarity``
    (``jaro.rs:112``).  Empty/1x1 special cases reduce to the right values
    through ``common == 0`` except both-empty (handled by the host layer).
    """
    LA = a.shape[-1]
    LB = b.shape[-1]
    B = max(a.shape[0], b.shape[0])
    la_b = jnp.broadcast_to(la, (B,)).astype(jnp.int32)
    lb_b = jnp.broadcast_to(lb, (B,)).astype(jnp.int32)
    a_b = jnp.broadcast_to(a, (B, LA))
    b_b = jnp.broadcast_to(b, (B, LB))
    amask = a_b >= 0

    # window bound + truncation (jaro.rs:457-470); bound clamps at 0 for
    # the 1x1 case which the formula then resolves exactly
    longer = jnp.maximum(la_b, lb_b)
    bound = jnp.maximum(longer // 2 - 1, 0)
    len1 = jnp.minimum(la_b, lb_b + bound)      # truncated pattern length
    len2 = jnp.minimum(lb_b, la_b + bound)      # truncated text length

    # common prefix within the truncated windows
    L = min(LA, LB)
    idx = jnp.arange(L, dtype=jnp.int32)
    pre_eq = (a_b[:, :L] == b_b[:, :L]) & (idx < jnp.minimum(len1, len2)[:, None])
    prefix = jnp.sum(jnp.cumprod(pre_eq.astype(jnp.int32), axis=-1),
                     axis=-1, dtype=jnp.int32)

    # greedy flagging scan over text positions; the per-step eq row is
    # computed in-scan (materialising [LB, B, LA] costs LB x the memory
    # and was the dominant cost for large batches)
    ii = jnp.arange(LA, dtype=jnp.int32)
    js = jnp.arange(LB, dtype=jnp.int32)

    def step(carry, j):
        pflag, tflag = carry
        bj = lax.dynamic_slice_in_dim(b_b, j, 1, axis=1)     # [B, 1]
        eq_j = (bj == a_b) & amask
        active = (j >= prefix) & (j < len2)
        window = (ii[None, :] >= (j - bound)[:, None]) & \
                 (ii[None, :] <= (j + bound)[:, None]) & \
                 (ii[None, :] >= prefix[:, None]) & \
                 (ii[None, :] < len1[:, None])
        avail = eq_j & window & ~pflag
        hit = jnp.any(avail, axis=-1) & active
        first = jnp.argmax(avail, axis=-1).astype(jnp.int32)
        claim = (ii[None, :] == first[:, None]) & hit[:, None]
        pflag = pflag | claim
        tflag = tflag | (hit[:, None] & (js[None, :] == j))
        return (pflag, tflag), None

    pflag0 = jnp.zeros((B, LA), bool)
    tflag0 = jnp.zeros((B, LB), bool)
    (pflag, tflag), _ = lax.scan(step, (pflag0, tflag0), js)

    nflag = jnp.sum(pflag, axis=-1, dtype=jnp.int32)
    common = prefix + nflag

    # transpositions: walk flagged text chars in order, each popping the
    # lowest remaining claimed pattern position and comparing chars
    # (count_transpositions_word, jaro.rs:339-368) — vector ops instead of
    # a stable-argsort compaction.
    def tstep(carry, j):
        rem, trans = carry
        pop = lax.dynamic_slice_in_dim(tflag, j, 1, axis=1)[:, 0]
        first = jnp.argmax(rem, axis=-1).astype(jnp.int32)
        ai = jnp.take_along_axis(a_b, first[:, None], axis=-1)[:, 0]
        bj = lax.dynamic_slice_in_dim(b_b, j, 1, axis=1)[:, 0]
        trans = trans + (pop & (ai != bj)).astype(jnp.int32)
        rem = rem & ~((ii[None, :] == first[:, None]) & pop[:, None])
        return (rem, trans), None

    (_, trans), _ = lax.scan(tstep, (pflag, jnp.zeros((B,), jnp.int32)), js)

    return common, trans
