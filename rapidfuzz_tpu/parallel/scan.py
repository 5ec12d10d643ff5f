"""Sharded one-vs-many / many-vs-many corpus scans.

Device-resident equivalent of running a ``BatchComparator`` over a large
corpus (``levenshtein.rs:1625-1657`` amortizes the query PM table; here the
corpus is sharded over the ``data`` mesh axis, the query is replicated, and
the compiled scan + optional top-k merge is reused across calls).
"""

from __future__ import annotations

import functools
import hashlib
import os
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import levenshtein as _lev_ops
from ..ops import lcs as _lcs_ops
from ..ops import osa as _osa_ops
from ..ops import damerau as _dam_ops
from ..ops import dispatch as _dispatch
from ..ops import jaro as _jaro_ops
from ..ops import route as _route
from ..ops import scan_kernel as _sk
from ..ops import simple as _simple_ops
from ..utils import codec as _codec
from .topk import topk_merge

_KERNELS: dict[str, Callable] = {
    "levenshtein": _lev_ops.uniform_distance,
    "indel": None,   # derived from lcs below
    "lcs_seq": _lcs_ops.lcs_similarity,
    "osa": _osa_ops.osa_distance,
    "damerau_levenshtein": _dam_ops.damerau_distance,
}


def _distance_fn(metric: str):
    if metric == "indel":
        def f(a, la, b, lb):
            sim = _lcs_ops.lcs_similarity(a, la, b, lb)
            B = sim.shape[0]
            tot = (jnp.broadcast_to(la, (B,)) + jnp.broadcast_to(lb, (B,)))
            return tot.astype(jnp.int32) - 2 * sim
        return f
    if metric == "lcs_seq":
        def f(a, la, b, lb):
            sim = _lcs_ops.lcs_similarity(a, la, b, lb)
            B = sim.shape[0]
            mx = jnp.maximum(jnp.broadcast_to(la, (B,)),
                             jnp.broadcast_to(lb, (B,)))
            return mx.astype(jnp.int32) - sim
        return f
    if metric in ("prefix", "postfix"):
        sim_fn = (_simple_ops.prefix_similarity if metric == "prefix"
                  else _simple_ops.postfix_similarity)

        def f(a, la, b, lb):
            sim = sim_fn(a, la, b, lb)
            B = sim.shape[0]
            mx = jnp.maximum(jnp.broadcast_to(la, (B,)),
                             jnp.broadcast_to(lb, (B,)))
            return mx.astype(jnp.int32) - sim
        return f
    if metric == "hamming":
        return _simple_ops.hamming_distance   # padding semantics
    fn = _KERNELS[metric]
    if fn is None:
        raise ValueError(metric)
    return fn


def sharded_distances(metric: str, mesh: Mesh, query, corpus_chars,
                      corpus_lens):
    """Distances of one query against a sharded corpus -> global array."""
    fn = _distance_fn(metric)
    shard = NamedSharding(mesh, P("data", None))
    shard1 = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    c = jax.device_put(corpus_chars, shard)
    lc = jax.device_put(corpus_lens, shard1)
    q = jax.device_put(query[0], repl)
    lq = jax.device_put(query[1], repl)

    jfn = jax.jit(fn, out_shardings=shard1)
    return jfn(q, lq, c, lc)


_F64_METRICS = ("jaro", "jaro_winkler")
_PARTIAL_METRICS = ("partial_ratio",)


def _kernel_finish(metric: str, raw, las, lens, wscale: int):
    """Kernel output [NQ, B] (Levenshtein distances or LCS lengths) ->
    the metric's distances."""
    la = las[:, None]
    if metric == "levenshtein":
        d = raw
    elif metric == "indel":
        d = la + lens[None, :] - 2 * raw
    else:                                               # lcs_seq
        return jnp.maximum(la, lens[None, :]) - raw
    return d * wscale if wscale != 1 else d


class CorpusScanner:
    """Precompiled one-vs-many scan over a device-resident sharded corpus.

    The corpus is encoded once, placed sharded over the mesh's ``data``
    axis, and every query scan reuses the compiled program — the
    BatchComparator pattern scaled out.  :func:`rapidfuzz_tpu.ops.route.
    pick_route` chooses the route: on GPU meshes, byte corpora under
    Levenshtein / indel / lcs_seq run the Pallas scan kernel over a
    length-sorted, byte-packed copy; every other case runs the XLA ops,
    chunked along the candidate axis (:func:`rapidfuzz_tpu.ops.dispatch.
    chunked`).  ``force_xla`` takes the XLA ops on every route (for
    measuring the kernel against them).
    """

    def __init__(self, corpus, metric: str = "levenshtein",
                 mesh: Mesh | None = None, bucket: int | None = None,
                 prefix_weight: float = 0.1, weights=None,
                 force_xla: bool = False):
        if mesh is None:
            devs = jax.devices()
            mesh = Mesh(devs, ("data",))
        self.mesh = mesh
        self.metric = metric
        self.prefix_weight = prefix_weight
        # weighted Levenshtein reduces algebraically where possible
        # (levenshtein.rs:1244-1279); only a general table needs the
        # Wagner-Fischer kernel
        self._wscale = 1
        self._weights = None
        self._zero = False
        if weights is not None and metric == "levenshtein":
            from ..distance.levenshtein import as_weight_table
            weights = as_weight_table(weights)
        if weights is not None and metric == "levenshtein" \
                and not weights.uniform:
            ins, dele, sub = (weights.insertion_cost, weights.deletion_cost,
                              weights.substitution_cost)
            if ins == dele == 0:
                self._zero = True
            elif ins == dele == sub:
                self._wscale = ins
            elif ins == dele and sub >= ins + dele:
                metric = self.metric = "indel"
                self._wscale = ins
            else:
                self._weights = (ins, dele, sub)
        # corpora whose elements exceed int32 are remapped through a dense
        # vocabulary; queries must then go through the *same* vocabulary
        # (pattern_match_vector.rs:104-154 overflow-hashmap equivalent).
        # A corpus containing int32.max itself also goes through the vocab:
        # the out-of-domain query sentinel (cmax+1 clipped to int32.max)
        # would otherwise collide with that real corpus char.
        self._vocab = None
        if corpus and all(type(s) is str for s in corpus):
            # vectorized ingestion: codepoints are always < 0x110000, so
            # neither the remap nor the int32.max-collision case can occur
            chars, lens = _codec.encode_batch(corpus, bucket)
        else:
            arrs = [_codec.encode_one(s) for s in corpus]
            if _codec._needs_remap(arrs) or any(
                    a.size and a.max() == np.iinfo(np.int32).max
                    for a in arrs):
                flat = (np.concatenate(arrs) if arrs
                        else np.empty(0, np.int64))
                self._vocab = np.unique(flat)
                arrs = [np.searchsorted(self._vocab, a).astype(np.int32)
                        for a in arrs]
            chars, lens = _codec.pad_batch(arrs, bucket)
        # corpus fingerprint: checkpoints must refuse to resume against a
        # different corpus of the same shape (silent result splicing).
        # chars+lens+vocab uniquely determine the original elements (the
        # vocab inverts the remap), so hashing the padded form is exact.
        h = hashlib.sha1()
        h.update(chars.tobytes())
        h.update(lens.tobytes())
        if self._vocab is not None:
            h.update(self._vocab.tobytes())
        self._fingerprint = h.hexdigest()
        n = len(lens)
        self.lengths = lens[:n].copy()     # host lengths, corpus order
        ndev = len(mesh.devices.flat)
        self._ndev = ndev
        self._cmax = int(chars.max()) if chars.size else 0
        self._LB = chars.shape[1]
        self._platform = _route.mesh_platform(mesh)
        self._kernel = not force_xla and _route.pick_route(
            self._platform, metric, self._LB, wide=self._cmax >= 256,
            weighted=self._weights is not None).kernel
        align = (_sk.BLOCK if self._kernel else 1) * ndev
        padded = -(-max(n, 1) // align) * align
        if padded != n:
            chars = np.concatenate(
                [chars, np.full((padded - n, chars.shape[1]), _codec.PAD,
                                np.int32)])
            # padded rows: length 0 — masked out of top-k by +inf distance
            lens = np.concatenate([lens, np.zeros(padded - n, np.int32)])
        self.n = n
        self._fn_cache: dict = {}
        # host copies in corpus order (padded)
        self._lens_host = lens
        if metric in _F64_METRICS:
            self._chars4 = chars[:, :4].copy()   # winkler prefix, host side
        if metric in _PARTIAL_METRICS:
            # partial_ratio: host window sweep over a compact host corpus
            # copy (windows batch through the XLA LCS kernel)
            self._pchars = self._compact_chars(chars)
        shard = NamedSharding(mesh, P("data"))
        # device_put straight from numpy shards host->device without
        # staging the full array on device 0 first
        self.lens = jax.device_put(lens, shard)
        if self._kernel:
            # the kernel scans a length-sorted packed copy, so each block
            # stops at its own longest candidate (the dynamic trip count).
            # Each shard sorts its own slice of the corpus and returns its
            # results to corpus order through its own inverse permutation,
            # so no result crosses devices; a corpus ordered by length
            # then loads its last shard most.
            S = padded // ndev
            local = [np.argsort(lens[k * S:(k + 1) * S], kind="stable")
                     for k in range(ndev)]
            order = np.concatenate([k * S + o for k, o in enumerate(local)])
            self._inv = jax.device_put(np.concatenate(
                [np.argsort(o) for o in local]).astype(np.int32), shard)
            self._sorted_lens = jax.device_put(lens[order], shard)
            self.cand = jax.block_until_ready(jax.jit(
                functools.partial(_sk.prepare_corpus, LB=self._LB),
                out_shardings=NamedSharding(mesh, P(None, "data")))(
                    jax.device_put(chars[order],
                                   NamedSharding(mesh, P("data", None)))))
            # the unpacked corpus serves only queries past the kernel's
            # word cap: built from the packed copy on first use
            self._xla_corpus = None
        else:
            # the XLA ops' [B, LB] corpus and its lengths
            self._xla_corpus = (jax.device_put(
                chars, NamedSharding(mesh, P("data", None))), self.lens)

    # ------------------------------------------------------------ routes

    def _smap(self, local, in_specs, out_specs):
        # check_vma off: pallas_call out_shapes carry no vma annotation
        return jax.shard_map(local, mesh=self.mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    def _kernel_fn(self, W: int, rows: int, G: int, one: bool):
        """Jitted kernel scan + metric finish per shard, returned to corpus
        order: (las [NQ], tabs, cand, lens, inv) -> [NQ, B], or [B] for
        ``one`` query."""
        key = ("kernel", W, rows, G, one)
        f = self._fn_cache.get(key)
        if f is None:
            metric, wscale = self.metric, self._wscale

            def local(las, tabs, cand, lens, inv):
                raw = _sk.run(las, tabs, cand, lens,
                              lcs=metric != "levenshtein", W=W, rows=rows,
                              G=G)
                d = jnp.take(_kernel_finish(metric, raw, las, lens, wscale),
                             inv, axis=1)
                return d[0] if one else d

            f = self._fn_cache[key] = jax.jit(self._smap(
                local, (P(), P(), P(None, "data"), P("data"), P("data")),
                P("data") if one else P(None, "data")))
        return f

    def _kernel_scan(self, qs, mode: str, G: int = 1):
        """Device distances (corpus order, padded) of same-word-bucket
        queries through the scan kernel: [len(qs), B], or [B] for one."""
        W = _sk.n_words(max(q.size for q in qs))
        rows = _sk.table_rows(mode)
        # host -> every device directly (not through device 0)
        las, tabs = jax.device_put(_sk.stage_queries(qs, rows, W),
                                   NamedSharding(self.mesh, P()))
        return self._kernel_fn(W, rows, G, len(qs) == 1)(
            las, tabs, self.cand, self._sorted_lens, self._inv)

    def _xla_fn(self):
        """Jitted XLA scan of one padded query over the mesh, chunked
        along the candidate axis."""
        f = self._fn_cache.get("xla")
        if f is None:
            if self.metric in _F64_METRICS:
                fn, out = _jaro_ops.jaro_components, (P("data"), P("data"))
            elif self._weights is not None:
                ins, dele, sub = self._weights
                fn = functools.partial(_lev_ops.weighted_distance, ins=ins,
                                       dele=dele, sub=sub)
                out = P("data")
            else:
                fn, out = _distance_fn(self.metric), P("data")
            f = self._fn_cache["xla"] = jax.jit(self._smap(
                _dispatch.chunked(fn), (P(), P(), P("data", None),
                                        P("data")), out))
        return f

    def _xla_chars(self):
        """[B, LB] i32 device corpus (corpus order) for the XLA ops; on
        the kernel route unpacked from the packed copy on first use."""
        if self._xla_corpus is None:
            LB = self._LB

            def unpack(cand, lens, inv):
                parts = [(cand >> jnp.uint32(8 * u)) & jnp.uint32(0xFF)
                         for u in range(4)]
                c = jnp.stack(parts, axis=1).reshape(LB, -1).T
                c = jnp.where(jnp.arange(LB)[None, :] < lens[:, None],
                              c.astype(jnp.int32), _codec.PAD)
                return jnp.take(c, inv, axis=0)

            self._xla_corpus = (jax.jit(self._smap(
                unpack, (P(None, "data"), P("data"), P("data")),
                P("data", None)))(self.cand, self._sorted_lens, self._inv),
                self.lens)
        return self._xla_corpus[0]

    def _xla_scan(self, q):
        qc, ql = _codec.pad_batch([q])
        out = self._xla_fn()(qc, ql, self._xla_chars(), self.lens)
        if self.metric in _F64_METRICS:
            return self._jaro_finish(out[0], out[1], q)
        return out * self._wscale if self._wscale != 1 else out

    def _encode_query(self, query):
        q = _codec.encode_one(query)
        if self._vocab is not None:
            idx = np.searchsorted(self._vocab, q).clip(0,
                                                       len(self._vocab) - 1)
            # chars absent from the corpus vocab map to an id no corpus
            # element uses, so they can never match
            miss = self._vocab[idx] != q
            q = np.where(miss, np.int64(len(self._vocab)), idx)
        elif q.size:
            # corpus was NOT vocab-remapped: query chars outside the int32
            # corpus domain can never match any corpus char, so map them
            # to one never-matching sentinel (query-internal equality is
            # irrelevant to every metric).  Without this, downstream
            # pad_batch would remap the query alone and silently break
            # cross-equality with the corpus.
            bad = (q < 0) | (q > np.iinfo(np.int32).max)
            if bad.any():
                q = np.where(bad, np.int64(min(self._cmax + 1,
                                               np.iinfo(np.int32).max)), q)
        return q

    def _jaro_finish(self, common, trans, q):
        """(common, trans) int components -> f64 distances, host-exact."""
        from ..distance import jaro as _jaro_mod

        common, trans = np.asarray(common), np.asarray(trans)
        lens = self._lens_host
        l1 = np.full_like(lens, q.size)
        sim = _jaro_mod.sim_from_components(common, trans, l1, lens)
        if self.metric == "jaro_winkler":
            P = min(4, q.size)
            if P:
                pe = (self._chars4[:, :P] == q[:P]) & \
                     (np.arange(P) < np.minimum(q.size, lens)[:, None])
                prefix = np.cumprod(pe.astype(np.int64), -1).sum(-1)
            else:
                prefix = np.zeros(lens.shape, np.int64)
            boosted = sim + prefix * self.prefix_weight * (1.0 - sim)
            sim = np.where(sim > 0.7, boosted, sim)
        return 1.0 - sim     # distance; host f64, exact

    @staticmethod
    def _compact_chars(chars: np.ndarray) -> np.ndarray:
        """Smallest-dtype host copy of the padded corpus (pads -> 0;
        lengths mask them everywhere the copy is read)."""
        mx = int(chars.max()) if chars.size else 0
        dt = (np.uint8 if mx < 256 else
              np.uint16 if mx < 65536 else np.int32)
        return np.where(chars < 0, 0, chars).astype(dt)

    def _partial_arrays(self, idx=None):
        """Encoded candidate arrays reconstructed from the host copy."""
        lens = self._lens_host
        rng = range(lens.shape[0]) if idx is None else idx
        return [self._pchars[i, :lens[i]].astype(np.int64) for i in rng]

    def _partial_host_all(self, q: np.ndarray) -> np.ndarray:
        from .. import fuzz as _fuzz
        return 1.0 - _fuzz._host_window_scores(q, self._partial_arrays())

    def _distances_dev(self, query):
        """Distances over the padded corpus (corpus order): a device array,
        or host f64 for the Jaro family and partial_ratio."""
        q = self._encode_query(query)
        if self._zero:
            return np.zeros(self.lens.shape[0], np.int64)
        if self.metric in _PARTIAL_METRICS:
            return self._partial_host_all(q)
        if self._kernel and _route.pick_route(
                self._platform, self.metric, self._LB,
                words=_sk.n_words(q.size)).kernel:
            return self._kernel_scan([q], _sk.pick_mode(q, self._cmax))
        return self._xla_scan(q)

    def distances(self, query, *, score_cutoff=None, score_hint=None):
        """Distances to every corpus string.

        Without ``score_cutoff``: a plain array.  With it: a
        ``(values, valid)`` :class:`BatchResult` — the batch rendering of
        the reference's ``Option`` results (``common.rs:33-46``), masked
        exactly after the full scan.  ``score_hint`` is accepted for API
        parity and never changes results.
        """
        from .. import common as _c

        d = np.asarray(self._distances_dev(query))[: self.n]
        if score_cutoff is None:
            return d
        return _dispatch.BatchResult(*_c.mask_distance(d, score_cutoff))

    #: queries per grouped scan_many dispatch: one launch and one table
    #: upload serve them all, and the kernel reuses each loaded text word
    #: across the queries of a program
    NQ_GROUP = 16

    @staticmethod
    def _topk_host(d: np.ndarray, k: int):
        """Deterministic host top-k: ids of the smallest k by (distance,
        corpus index).  Plain ``argpartition[:k]`` picks arbitrary members
        of a tie set straddling the k boundary; widening to the tie
        boundary before ordering makes every route agree."""
        if k >= d.size:
            cand = np.arange(d.size)
        else:
            part = np.argpartition(d, k - 1)[:k]
            cand = np.nonzero(d <= d[part].max())[0]
        return cand[np.lexsort((cand, d[cand]))][:k]

    def _topk_of(self, dist, k: int):
        """(values, ids) of the k nearest in padded corpus-order distances
        (``[B]``, or ``[rows, B]`` per row): on device for integer
        distances (``topk_merge``: ``lax.top_k`` keeps the lower index
        first among ties, the same (distance, index) order as
        :meth:`_topk_host`), on the host for the f64 routes."""
        k = min(k, self.n)
        if k == 0:
            shape = dist.shape[:-1] + (0,)
            return np.empty(shape, np.int64), np.empty(shape, np.int32)
        if isinstance(dist, np.ndarray):    # host f64 (jaro family)
            ids = self._topk_host(dist[: self.n], k)
            return dist[ids], ids.astype(np.int32)
        key = ("topk_in", dist.ndim)
        f = self._fn_cache.get(key)
        if f is None:
            n = self.n

            def prep(dist):
                # integer distances are exact in float32 below 2**24, far
                # above any distance a corpus bucket can produce
                idx = jnp.arange(dist.shape[-1], dtype=jnp.int32)
                return (jnp.where(idx < n, dist.astype(jnp.float32),
                                  jnp.inf), idx)

            f = self._fn_cache[key] = jax.jit(prep, out_shardings=(
                NamedSharding(self.mesh,
                              P(*(None,) * (dist.ndim - 1), "data")),
                NamedSharding(self.mesh, P("data"))))
        vals, ids = topk_merge(*f(dist), k, self.mesh, largest=False)
        return np.asarray(vals).astype(np.int64), np.asarray(ids)

    def _nq_eligible(self) -> bool:
        """scan_many can batch queries into grouped kernel dispatches on
        the kernel route (the packed corpus is query-independent)."""
        return self._kernel and not self._zero

    def _distances_many(self, queries):
        """Padded corpus-order device distances of the queries, as
        ``(query positions, [>= len(positions), B] array)`` blocks (rows
        past the positions are padding), via grouped multi-query
        dispatches.

        Queries are encoded, grouped by (word bucket, table mode), padded
        to :data:`NQ_GROUP` by repeating the group's last query (one
        compilation serves every group; padded rows are dropped) — the
        ``BatchComparator`` PM reuse pattern (``levenshtein.rs:1625-1657``)
        extended to many queries per kernel launch.  Queries past the
        kernel's word cap scan one at a time on the XLA route.
        """
        enc = [self._encode_query(q) for q in queries]
        out = []
        groups: dict = {}
        for i, q in enumerate(enc):
            r = _route.pick_route(self._platform, self.metric, self._LB,
                                  grouped=True, words=_sk.n_words(q.size))
            if not r.kernel:
                out.append(([i], self._xla_scan(q)[None]))
                continue
            key = (_sk.n_words(q.size), _sk.pick_mode(q, self._cmax),
                   r.group)
            groups.setdefault(key, []).append(i)
        for (_, mode, G), idxs in groups.items():
            for s in range(0, len(idxs), self.NQ_GROUP):
                part = idxs[s: s + self.NQ_GROUP]
                qs = [enc[i] for i in part]
                qs = qs + [qs[-1]] * (self.NQ_GROUP - len(qs))
                out.append((part, self._kernel_scan(qs, mode, G)))
        return out

    def _ckpt_fingerprint(self, queries) -> str:
        """Corpus+queries+metric content hash stored in checkpoints."""
        qh = hashlib.sha1()
        for s in queries:
            qh.update(_codec.encode_one(s).tobytes())
            qh.update(b";")
        return f"{self._fingerprint}:{qh.hexdigest()}:{self.metric}"

    def scan_many(self, queries, *, k: int | None = None,
                  checkpoint_path: str | None = None,
                  checkpoint_every: int = 256):
        """Scan a stream of queries; optionally checkpoint + resume.

        Returns ``[nq, n]`` distances (or, with ``k``, a pair of
        ``[nq, k]`` value/index arrays).  With ``checkpoint_path``,
        partial results are written every ``checkpoint_every`` queries and
        an interrupted run resumes from the last checkpoint — the
        SURVEY.md §5 note: the only state worth persisting is partial scan
        output; corpus/PM state is cheap to rebuild, exactly like the
        reference's ``BatchComparator``.
        """
        queries = list(queries)
        nq = len(queries)
        done = 0
        if k is None:
            vals = np.zeros((nq, self.n), np.float64)
            ids = None
        else:
            vals = np.full((nq, k), np.inf)
            ids = np.full((nq, k), -1, np.int64)
        # content fingerprint: shape equality alone would silently splice
        # results from a different corpus/query list of the same sizes
        fp = self._ckpt_fingerprint(queries)
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            ck = np.load(checkpoint_path)
            if int(ck["n"]) == self.n and int(ck["nq"]) == nq \
                    and (k or 0) == int(ck["k"]) \
                    and str(ck.get("fp", "")) == fp:
                done = int(ck["done"])
                vals[:done] = ck["vals"][:done]
                if ids is not None:
                    ids[:done] = ck["ids"][:done]

        def _save(done):
            if checkpoint_path is None:
                return
            tmp = checkpoint_path + ".tmp.npz"
            np.savez(tmp, n=self.n, nq=nq, k=k or 0, done=done, vals=vals,
                     ids=ids if ids is not None else np.empty(0), fp=fp)
            os.replace(tmp, checkpoint_path)

        if self._nq_eligible() and nq - done > 1:
            # grouped multi-query dispatches between checkpoint boundaries
            qi = done
            while qi < nq:
                stop = min(nq, (qi // checkpoint_every + 1)
                           * checkpoint_every)
                for pos, d in self._distances_many(queries[qi:stop]):
                    rows = qi + np.asarray(pos)
                    if k is None:
                        vals[rows] = np.asarray(d)[: rows.size, : self.n]
                    else:
                        v, i = self._topk_of(d, k)
                        vals[rows, : v.shape[1]] = v[: rows.size]
                        ids[rows, : i.shape[1]] = i[: rows.size]
                qi = stop
                if checkpoint_path is not None and qi < nq:
                    _save(qi)
        else:
            for qi in range(done, nq):
                if k is None:
                    vals[qi] = self.distances(queries[qi])
                else:
                    v, i = self.topk(queries[qi], k)
                    vals[qi, : len(v)] = v
                    ids[qi, : len(i)] = i
                if checkpoint_path is not None \
                        and (qi + 1) % checkpoint_every == 0:
                    _save(qi + 1)
        _save(nq)
        return vals if k is None else (vals, ids)

    def topk(self, query, k: int, *, score_cutoff=None):
        """(distances[k], corpus_indices[k]) of the k nearest strings.

        With ``score_cutoff``, entries above the cutoff are excluded
        (fewer than ``k`` results may return).
        """
        if k <= 0:
            return np.empty(0), np.empty(0, np.int32)
        if score_cutoff is not None:
            res = self.distances(query, score_cutoff=score_cutoff)
            vals, valid = res.values, res.valid
            d = np.where(valid, vals.astype(np.float64), np.inf)
            k = min(k, int(valid.sum()))
            if k == 0:
                return np.empty(0, vals.dtype), np.empty(0, np.int32)
            ids = self._topk_host(d, k)
            return vals[ids], ids.astype(np.int32)
        # padding rows are masked out and k clamps to the real corpus
        # size, so they never surface (empty corpus -> empty)
        return self._topk_of(self._distances_dev(query), k)
