"""Length-bucketed composite scanner for heterogeneous corpora.

:class:`~rapidfuzz_tpu.parallel.scan.CorpusScanner` pads its whole
corpus to ONE bucket.  On the scan kernel's route the per-block trip
counts stop the COMPUTE at each block's longest candidate (the corpus is
length-sorted), but the packed corpus still spans the bucket width, and
on the XLA route every candidate pays the full bucket — a corpus of
mostly-20-char strings with a few 1000-char outliers pays ~50x the
necessary memory, and a single outlier past the kernel's bucket cap
moves the whole corpus onto the XLA route.

:class:`BucketedScanner` splits the corpus into length classes (64 /
256 / 4096 chars: the two- and eight-word query shapes and the kernel's
bucket cap, ``ops.route.KERNEL_MAX_LB``), builds one device-resident
``CorpusScanner`` per
populated class, and merges results back to corpus order on host.  A
class is only split off when it has enough members to fill real kernel
tiles (``min_split``), so homogeneous corpora collapse to a single
child and behave exactly like a plain scanner.

The public surface mirrors ``CorpusScanner``: ``distances`` / ``topk``
/ ``scan_many`` (incl. per-class checkpoint/resume), so it drops into
``process.cdist``/``extract`` via the ``_scanner`` parameter.
"""

from __future__ import annotations

import numpy as np

from ..ops.route import KERNEL_MAX_LB
from ..utils import codec as _codec
from .scan import CorpusScanner

#: class edges: <=64, <=256, <= the scan kernel's bucket cap, and
#: everything above (XLA route)
EDGES = (64, 256, KERNEL_MAX_LB)


class BucketedScanner:
    """Composite of per-length-class :class:`CorpusScanner` children."""

    def __init__(self, corpus, metric: str = "levenshtein", mesh=None,
                 min_split: int = 2048, **kw):
        corpus = list(corpus)
        self.metric = metric
        self.n = len(corpus)
        lens = np.array([_codec.encode_one(s).size for s in corpus],
                        np.int64)
        self.lengths = lens.astype(np.int32)

        # assign to edge classes, then merge classes too small to fill
        # kernel tiles into the next populated class above (the topmost
        # class merges downward)
        cls = np.searchsorted(np.array(EDGES), lens, side="left")
        counts = np.bincount(cls, minlength=len(EDGES) + 1)
        order = [c for c in range(len(EDGES) + 1) if counts[c]]
        groups: list[list[int]] = []
        cur: list[int] = []
        for c in order:
            cur.append(c)
            if sum(int(counts[x]) for x in cur) >= min_split:
                groups.append(cur)
                cur = []
        if cur:
            if groups:
                groups[-1].extend(cur)
            else:
                groups.append(cur)
        if not groups:          # empty corpus: one empty child keeps the
            groups.append([0])  # whole surface well-defined

        self._children = []
        self._index = []          # original corpus indices per child
        for g in groups:
            mask = np.isin(cls, g)
            idx = np.flatnonzero(mask)
            sub = [corpus[i] for i in idx]
            self._children.append(CorpusScanner(sub, metric=metric,
                                                mesh=mesh, **kw))
            self._index.append(idx)

    @property
    def classes(self):
        """(child count, per-child sizes) — introspection/tests."""
        return [idx.size for idx in self._index]

    def _nq_eligible(self) -> bool:
        # scan_many composes children internally, so the process layer
        # can always batch queries through it
        return True

    def distances(self, query, *, score_cutoff=None, score_hint=None):
        from .. import common as _c
        from ..ops import dispatch as _dispatch

        if score_cutoff is None:
            out = None
            for sc, idx in zip(self._children, self._index):
                d = np.asarray(sc.distances(query, score_hint=score_hint))
                if out is None:
                    out = np.empty(self.n, d.dtype)
                out[idx] = d
            return out
        vals = np.empty(self.n, np.float64)
        for sc, idx in zip(self._children, self._index):
            r = sc.distances(query, score_cutoff=score_cutoff,
                             score_hint=score_hint)
            vals[idx] = r.values
        return _dispatch.BatchResult(*_c.mask_distance(vals, score_cutoff))

    def topk(self, query, k: int, *, score_cutoff=None):
        """(values[<=k], corpus_indices) — per-class top-k, merged by
        (value, index)."""
        vs, ids = [], []
        for sc, idx in zip(self._children, self._index):
            if idx.size == 0:
                continue
            v, i = sc.topk(query, k, score_cutoff=score_cutoff)
            vs.append(np.asarray(v, np.float64))
            ids.append(idx[np.asarray(i, np.int64)])
        if not vs:
            return np.empty(0), np.empty(0, np.int32)
        v = np.concatenate(vs)
        i = np.concatenate(ids)
        take = np.lexsort((i, v))[:k]
        return v[take], i[take].astype(np.int32)

    def scan_many(self, queries, *, k: int | None = None,
                  checkpoint_path: str | None = None,
                  checkpoint_every: int = 256):
        """[nq, n] distances (or merged (vals, ids) pairs with ``k``);
        checkpoints are per-child files (``<path>.c<i>``), so resume
        composes from each child's own resume."""
        queries = list(queries)
        nq = len(queries)
        if k is None:
            out = None
            for ci, (sc, idx) in enumerate(zip(self._children,
                                               self._index)):
                cp = (f"{checkpoint_path}.c{ci}" if checkpoint_path
                      else None)
                d = np.asarray(sc.scan_many(
                    queries, checkpoint_path=cp,
                    checkpoint_every=checkpoint_every))
                if out is None:
                    out = np.empty((nq, self.n), d.dtype)
                out[:, idx] = d
            return out
        vals = np.full((nq, k), np.inf)
        ids = np.full((nq, k), -1, np.int64)
        for ci, (sc, idx) in enumerate(zip(self._children, self._index)):
            if idx.size == 0:
                continue
            cp = f"{checkpoint_path}.c{ci}" if checkpoint_path else None
            v, i = sc.scan_many(queries, k=k, checkpoint_path=cp,
                                checkpoint_every=checkpoint_every)
            v = np.asarray(v, np.float64)
            gi = np.where(np.asarray(i) >= 0,
                          idx[np.clip(np.asarray(i), 0, idx.size - 1)],
                          -1)
            mv = np.concatenate([vals, v], axis=1)
            mi = np.concatenate([ids, gi], axis=1)
            for qi in range(nq):
                take = np.lexsort((np.where(mi[qi] < 0, np.iinfo(np.int64)
                                            .max, mi[qi]), mv[qi]))[:k]
                vals[qi] = mv[qi, take]
                ids[qi] = mi[qi, take]
        return vals, ids.astype(np.int32)
