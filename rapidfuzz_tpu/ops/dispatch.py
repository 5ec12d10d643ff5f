"""Device dispatch: jitted kernel entry points + bucketed batch execution.

JAX caches compilations per input shape; the codec's length buckets
(``utils/codec.py``) bound the number of distinct shapes, replacing the
reference's run-time kernel ladder with trace-time bucket selection
(SURVEY.md §7 design stance).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

#: bytes of per-candidate intermediates (the ``[rows, LB, LA]`` equality
#: planes and PM columns) one chunk of an XLA scan may hold
XLA_CHUNK_BYTES = 4 << 30


class BatchResult(NamedTuple):
    """Batch score result: ``values`` plus a ``valid`` mask.

    The mask is the batch equivalent of the reference's ``Option<T>``
    results under ``WithScoreCutoff`` (``src/common.rs:33-46``).
    """
    values: np.ndarray
    valid: np.ndarray

    def tolist(self):
        return [v if ok else None
                for v, ok in zip(self.values.tolist(), self.valid.tolist())]


@functools.cache
def jit_kernel(fn, *static_kv):
    """jit with keyword static args, cached per (fn, statics)."""
    statics = dict(static_kv)
    if statics:
        return jax.jit(functools.partial(fn, **statics))
    return jax.jit(fn)


def run_pairs(kernel, c1, l1, c2, l2, **static) -> np.ndarray:
    """Execute a batched pair kernel on device, return numpy."""
    fn = jit_kernel(kernel, *sorted(static.items()))
    out = fn(c1, l1, c2, l2)
    return np.asarray(jax.device_get(out))


def chunked(fn):
    """Wrap a pair op ``fn(a, la, b, lb)`` whose intermediates grow as
    ``B * LB * LA`` so the candidate axis of ``b``/``lb`` runs in chunks
    whose intermediates stay under :data:`XLA_CHUNK_BYTES` (read at trace
    time).  ``a``/``la`` (the query side) broadcast against every chunk.
    Outputs may be one ``[B]`` array or a tuple of them.
    """
    def run(a, la, b, lb):
        B, LB = b.shape
        rows = max(1, XLA_CHUNK_BYTES // (4 * LB * max(a.shape[-1], 32)))
        if rows >= B:
            return fn(a, la, b, lb)
        n = -(-B // rows)
        pad = n * rows - B
        bc = jnp.pad(b, ((0, pad), (0, 0)), constant_values=-1)
        lbc = jnp.pad(lb, (0, pad))
        out = lax.map(lambda x: fn(a, la, x[0], x[1]),
                      (bc.reshape(n, rows, LB), lbc.reshape(n, rows)))
        return jax.tree.map(lambda o: o.reshape(n * rows)[:B], out)
    return run
