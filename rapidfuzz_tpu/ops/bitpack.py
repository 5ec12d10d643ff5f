"""Bit-vector primitives on u32 lanes.

The reference's core data structure is the pattern-match (PM) bitvector
table: one 64-bit mask per alphabet symbol with bit ``i`` set iff
``pattern[i] == symbol`` (``/root/reference/src/details/pattern_match_vector.rs``).
The XLA kernels never build a per-symbol table + per-char gather; instead
they materialise the *per-text-position* PM columns directly from an
equality matrix — a broadcast compare that vectorises — and pack them into
``uint32`` words (the reference's u64 words become 2x u32 with explicit
carries, so JAX needs no 64-bit mode; see ``src/details/intrinsics.rs:25-29``
for the carry semantics we emulate).  The GPU scan kernel
(``ops/scan_kernel.py``) reads a per-symbol table instead.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

WORD = 32
# plain numpy scalars: module-level jnp.uint32(...) would CREATE A DEVICE
# ARRAY AT IMPORT TIME, initializing the XLA backend before the user can
# call jax.distributed.initialize (observed: multi-process init rejected
# after a mere `import rapidfuzz_tpu`)
FULL = np.uint32(0xFFFFFFFF)
ONE = np.uint32(1)
ZERO = np.uint32(0)


def eq_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Equality matrix eq[..., j, i] = (b[..., j] == a[..., i]).

    a: int32[B, LA] pattern chars (PAD = -1 never matches a PAD in b because
    both being PAD would be a false match -- callers must therefore mask one
    side; we handle it here by masking `a` pads).
    """
    eq = b[..., :, None] == a[..., None, :]
    # PAD==PAD must not match
    eq = jnp.logical_and(eq, a[..., None, :] >= 0)
    return eq


def pack_bits(eq: jnp.ndarray) -> jnp.ndarray:
    """Pack a boolean array's last axis (multiple of 32) into uint32 words.

    eq[..., N] -> out[..., N//32], bit k of word w = eq[..., w*32+k].
    """
    n = eq.shape[-1]
    assert n % WORD == 0, n
    w = n // WORD
    e = eq.reshape(eq.shape[:-1] + (w, WORD)).astype(jnp.uint32)
    weights = ONE << jnp.arange(WORD, dtype=jnp.uint32)
    return jnp.sum(e * weights, axis=-1, dtype=jnp.uint32)


def pm_columns(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """PM columns for a batch of pairs: pm[B, LB, W] uint32.

    ``pm[b, j, w]`` bit ``k`` is set iff ``a[b, w*32+k] == b[b, j]``.
    Equivalent to the reference's ``pm.get(word, ch2)`` lookups
    (``src/distance/levenshtein.rs:843``) but computed by compare+pack,
    which keeps everything in vector ops instead of per-char gathers.
    """
    return pack_bits(eq_matrix(a, b))


def popcount(x: jnp.ndarray) -> jnp.ndarray:
    return lax.population_count(x).astype(jnp.int32)


def select_word(words: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """words[..., W] uint32, idx[...] int32 -> words[..., idx] elementwise.

    Implemented as a masked sum over the (small, static) word axis to avoid
    gathers.
    """
    w = words.shape[-1]
    wid = jnp.arange(w, dtype=jnp.int32)
    mask = wid == idx[..., None]
    return jnp.sum(jnp.where(mask, words, ZERO), axis=-1, dtype=jnp.uint32)


def test_bit(words: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Bit ``pos`` of a multi-word little-endian bitvector, as int32 0/1.

    words[..., W] uint32; pos[...] int32 (must be >= 0).
    """
    word = select_word(words, pos >> 5)
    bit = (pos & 31).astype(jnp.uint32)
    return ((word >> bit) & ONE).astype(jnp.int32)


def lsb_mask(n: jnp.ndarray) -> jnp.ndarray:
    """uint32 mask of the n lowest bits, n in [0, 32] (traced), UB-safe.

    Mirrors ``bit_mask_lsb_u64`` (``src/details/intrinsics.rs:31-37``).
    """
    n = jnp.asarray(n)
    full = n >= 32
    m = (ONE << jnp.where(full, 0, n).astype(jnp.uint32)) - ONE
    return jnp.where(full, FULL, m)


def blsi(x: jnp.ndarray) -> jnp.ndarray:
    """Lowest set bit (``x & -x``), u32. ``src/details/intrinsics.rs:38-40``."""
    return x & (jnp.uint32(0) - x)


def add_with_carry(x: jnp.ndarray, y: jnp.ndarray, c: jnp.ndarray):
    """(x + y + c) mod 2^32 with carry-out, all uint32 (c in {0,1}).

    Emulates ``carrying_add`` (``src/details/intrinsics.rs:25-29``) so
    multi-word adds behave exactly like the reference's u64 arithmetic.
    """
    s1 = x + y
    c1 = (s1 < x).astype(jnp.uint32)
    s2 = s1 + c
    c2 = (s2 < s1).astype(jnp.uint32)
    return s2, c1 | c2
