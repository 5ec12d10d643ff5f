"""Distributed top-k merge over a data-sharded score vector.

Per-shard ``lax.top_k`` then an ``all_gather`` of the k-sized partials and a
final merge — k is small, so the collective moves O(ndev * k) elements over
ICI instead of the full score vector (SURVEY.md §5 distributed backend
plan).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P


def topk_merge(scores: jnp.ndarray, indices: jnp.ndarray, k: int,
               mesh: Mesh, largest: bool = True):
    """Global top-k along the last axis of data-sharded ``scores``.

    scores: [..., C] sharded on ``data`` along C; indices: [C] global ids,
    sharded alike.  Returns (values[..., k], idx[..., k]) replicated on
    every device.  Among equal scores the lower position comes first
    (``lax.top_k`` per shard, then over the shard-ordered gather).
    """
    return _merge_fn(mesh, k, largest, scores.ndim)(scores, indices)


@functools.cache
def _merge_fn(mesh: Mesh, k: int, largest: bool, ndim: int):
    """The compiled merge, built once per (mesh, k, direction, rank)."""
    sign = 1.0 if largest else -1.0

    def local(scores_shard, idx_shard):
        local_k = min(k, scores_shard.shape[-1])
        v, pos = lax.top_k(sign * scores_shard.astype(jnp.float32), local_k)
        i = jnp.take(idx_shard, pos)
        # gather the per-shard candidates to every device
        v_all = lax.all_gather(v, "data", axis=ndim - 1, tiled=True)
        i_all = lax.all_gather(i, "data", axis=ndim - 1, tiled=True)
        vg, posg = lax.top_k(v_all, min(k, v_all.shape[-1]))
        return sign * vg, jnp.take_along_axis(i_all, posg, axis=-1)

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(*(None,) * (ndim - 1), "data"), P("data")),
        out_specs=(P(), P()),
        check_vma=False,
    ))
