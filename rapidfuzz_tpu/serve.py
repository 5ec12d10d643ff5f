"""Production serving layer: an HTTP daemon around :class:`CorpusScanner`.

The reference is a library with no runtime (SURVEY.md §1: "no service, no
scheduler"); on an accelerator the natural unit of service is the
device-resident corpus scan — load the corpus once, keep it sharded on
the mesh, answer one-vs-many queries over HTTP.  Stdlib-only (no extra
dependencies in the image).

Endpoints (JSON):

* ``GET /health``                 -> ``{"ok": true, "n": corpus_size}``
* ``GET /stats``                  -> counters (queries, pairs, seconds)
* ``POST /reload`` body ``{"corpus": [str]}`` or ``{"path": file}``
                                  -> ``{"ok": true, "n": new_size}``
  (hot corpus swap: the new scanner builds outside the lock, in-flight
  queries keep the old corpus until the atomic swap.  ``path`` reads a
  server-local file — operator input; the daemon binds 127.0.0.1 by
  default and has no auth, so do not expose it beyond trusted hosts)
* ``POST /topk``    body ``{"query": str, "k": int, "score_cutoff"?: num}``
                                  -> ``{"values": [...], "indices": [...],
                                        "strings": [...]}``
* ``POST /distances`` body ``{"query": str, "score_cutoff"?: num}``
                                  -> ``{"values": [...], "valid"?: [...]}``
* ``POST /batch``   body ``{"queries": [str], "k"?: int}``
                                  -> ``{"values": [[...]], "indices"?:
                                        [[...]], "strings"?: [[...]]}``
  (rides ``CorpusScanner.scan_many`` — eligible query streams share
  kernel dispatches in groups of 16, the sustained-throughput serving
  path)
* ``POST /editops`` body ``{"s1": str, "s2"?: str, "index"?: int}``
                                  -> ``{"distance", "editops", "opcodes"}``
  (alignment of two strings, or of ``s1`` vs corpus entry ``index``)
* ``POST /extract`` body ``{"query": str, "scorer"?: str, "limit"?: int,
                            "score_cutoff"?: num, "with_editops"?: bool}``
                                  -> ``{"results": [[string, score, idx]]}``
  (``with_editops`` appends each hit's edit script — one batched
  recording dispatch over the surviving hits; levenshtein / indel /
  lcs_seq / ratio scorers)
  (any registered scorer incl. the fuzz family — WRatio, partial_ratio,
  token_*.  Scores are normalized SIMILARITIES in [0, 1], so its
  ``score_cutoff`` is a similarity floor — unlike /topk and /distances,
  whose cutoff bounds the metric's distance.  The service's own metric
  reuses the device-resident scanner; other metric scorers build one per
  scorer on first use)

Run::

    python -m rapidfuzz_tpu.serve --corpus words.txt --metric levenshtein \
        --port 8947

JAX dispatch is single-threaded by design here: requests serialize
through a lock (a corpus scan fills the device; concurrency would only
interleave device programs).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .ops.route import KERNEL_MAX_WORDS
from .parallel.scan import CorpusScanner
from .utils import compile_cache


class ScanService:
    """Device-resident corpus + compiled scan programs + counters."""

    def __init__(self, corpus, metric: str = "levenshtein", mesh=None,
                 bucket: int | None = None, auto_bucket: bool = False,
                 **scanner_kw):
        self._build_kw = dict(metric=metric, mesh=mesh, bucket=bucket,
                              auto_bucket=auto_bucket, **scanner_kw)
        self.corpus = list(corpus)
        self.scanner = self._build_scanner(self.corpus)
        self.metric = metric
        # /extract may only reuse this scanner when it scores the plain
        # metric: weights/prefix_weight would leak into the [0, 1]
        # normalized-similarity contract
        self._scanner_parameterized = bool(scanner_kw)
        self._lock = threading.Lock()
        self._extra_scanners: dict = {}
        self.stats = {"queries": 0, "pairs": 0, "device_seconds": 0.0}

    def _build_scanner(self, corpus):
        kw = dict(self._build_kw)
        metric = kw.pop("metric")
        mesh = kw.pop("mesh")
        bucket = kw.pop("bucket")
        if kw.pop("auto_bucket"):
            from .parallel.bucketed import BucketedScanner
            return BucketedScanner(corpus, metric=metric, mesh=mesh, **kw)
        return CorpusScanner(corpus, metric=metric, mesh=mesh,
                             bucket=bucket, **kw)

    def warmup(self, full: bool = False):
        """Precompile the corpus's scan routes before serving traffic.

        The reference's contract is that a library call never compiles,
        so a production server absorbs every route's first compile
        before binding the port.  ``full`` also runs the cutoff, grouped
        scan_many and top-k routes.  Returns a route -> seconds table
        (the cold-start catalog; ~0 s entries mean the persistent
        compilation cache already covered the route).  A route that
        fails records ``"error: ..."`` instead of a time.
        """
        if not self.corpus:
            return {}
        # FULL-length warm query: the query length is a compile key
        # (32-char buckets for the kernels' padded query shapes), so a
        # truncated warm-up would leave the real corpus-scale query
        # shape cold and the first production request would absorb the
        # compile the warmup exists to prevent
        q = max(self.corpus, key=len) or "a"
        q_short = q[:64] or "a"
        times = {}

        def step(name, fn):
            t0 = time.perf_counter()
            try:
                fn()
            except Exception as e:   # a route that cannot serve this
                times[name] = f"error: {type(e).__name__}: {e}"
                return
            times[name] = round(time.perf_counter() - t0, 3)

        step("distances", lambda: self.scanner.distances(q))
        if q_short != q:
            step("distances_short",
                 lambda: self.scanner.distances(q_short))
        if full:
            # the query's 32-char word count is a compile key of the scan
            # kernel: warm every shorter word bucket it serves too
            for w in range(1, min(-(-len(q) // 32),
                                  KERNEL_MAX_WORDS + 1)):
                step(f"distances_w{w}",
                     lambda w=w: self.scanner.distances(q[: 32 * w]))
            step("distances_cutoff",
                 lambda: self.scanner.distances(q, score_cutoff=8))
            step("topk", lambda: self.scanner.topk(q, k=3))
            if hasattr(self.scanner, "scan_many"):
                step("scan_many",
                     lambda: self.scanner.scan_many([q, q[:-1] or "a"]))
        return times

    def reload(self, corpus):
        """Swap in a new corpus: the replacement scanner (and its device
        upload) is built OUTSIDE the lock, so in-flight queries keep
        serving the old corpus until the atomic swap."""
        corpus = list(corpus)
        scanner = self._build_scanner(corpus)
        with self._lock:
            self.corpus = corpus
            self.scanner = scanner
            self._extra_scanners = {}
        return {"ok": True, "n": scanner.n}

    def _timed(self, fn, nq: int = 1):
        with self._lock:
            t0 = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t0
            self.stats["queries"] += nq
            self.stats["pairs"] += nq * self.scanner.n
            self.stats["device_seconds"] += dt
        return out

    def topk(self, query: str, k: int, score_cutoff=None):
        vals, ids = self._timed(
            lambda: self.scanner.topk(query, k, score_cutoff=score_cutoff))
        return {
            "values": np.asarray(vals).tolist(),
            "indices": np.asarray(ids).tolist(),
            "strings": [self.corpus[i] for i in np.asarray(ids)],
        }

    def distances(self, query: str, score_cutoff=None, score_hint=None):
        res = self._timed(
            lambda: self.scanner.distances(query,
                                           score_cutoff=score_cutoff,
                                           score_hint=score_hint))
        if score_cutoff is None:
            return {"values": np.asarray(res).tolist()}
        return {"values": np.asarray(res.values).tolist(),
                "valid": np.asarray(res.valid).tolist()}

    def batch(self, queries, k=None):
        out = self._timed(lambda: self.scanner.scan_many(queries, k=k),
                          nq=len(queries))
        if k is None:
            return {"values": np.asarray(out).tolist()}
        vals, ids = out
        return {"values": np.asarray(vals).tolist(),
                "indices": np.asarray(ids).tolist(),
                "strings": [[self.corpus[i] if i >= 0 else None
                             for i in row] for row in np.asarray(ids)]}

    def editops(self, s1: str, s2=None, index=None):
        """Alignment between two strings (or query vs a corpus entry)."""
        if s2 is None:
            s2 = self.corpus[int(index)]
        from .distance import levenshtein
        ops = self._timed(lambda: levenshtein.editops(s1, s2))
        oc = ops.as_opcodes()
        return {
            "distance": len(ops),
            "editops": [[o.tag, o.src_pos, o.dest_pos] for o in ops],
            "opcodes": [[o.tag, o.src_start, o.src_end, o.dest_start,
                         o.dest_end] for o in oc],
        }

    def extract(self, query: str, scorer: str, limit: int,
                score_cutoff=None, with_editops: bool = False):
        """process.extract over the corpus with any registered scorer.

        Scores are ``normalized_similarity`` in [0, 1] (best first) — a
        ``score_cutoff`` here is a similarity floor, NOT the distance
        bound that /topk and /distances use.  When the requested scorer
        is this service's own metric, the device-resident scanner is
        reused; the fuzz family batches through the device kernels; any
        other callable scores pairwise (modest corpora / re-ranking).
        """
        from .models import process
        from .models.process import _SCANNER_METRICS

        def run():
            # scanner selection/construction stays inside the lock: all
            # device dispatch (including compiles) is serialized by design
            scanner = None
            if scorer == self.metric and not self._scanner_parameterized:
                scanner = self.scanner
            elif scorer in _SCANNER_METRICS:
                scanner = self._extra_scanners.get(scorer)
                if scanner is None:
                    scanner = CorpusScanner(self.corpus, metric=scorer)
                    self._extra_scanners[scorer] = scanner
            fn = (process.extract_editops if with_editops
                  else process.extract)
            return fn(query, self.corpus, scorer=scorer, limit=limit,
                      score_cutoff=score_cutoff, _scanner=scanner)

        res = self._timed(run)
        if with_editops:
            return {"results": [
                [s, v, i, [[o.tag, o.src_pos, o.dest_pos] for o in ops]]
                for s, v, i, ops in res]}
        return {"results": [[s, v, i] for s, v, i in res]}


def make_server(service: ScanService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) an HTTP server bound to ``host:port``
    (port 0 picks a free one; see ``server.server_address``)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):     # library core stays silent
            pass

        def _reply(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"ok": True, "n": service.scanner.n,
                                  "metric": service.metric})
            elif self.path == "/stats":
                self._reply(200, service.stats)
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                cutoff = req.get("score_cutoff")
                if self.path == "/topk":
                    out = service.topk(req["query"], int(req.get("k", 10)),
                                       score_cutoff=cutoff)
                elif self.path == "/distances":
                    out = service.distances(req["query"],
                                            score_cutoff=cutoff,
                                            score_hint=req.get(
                                                "score_hint"))
                elif self.path == "/batch":
                    k = req.get("k")
                    out = service.batch(list(req["queries"]),
                                        k=None if k is None else int(k))
                elif self.path == "/editops":
                    out = service.editops(req["s1"], req.get("s2"),
                                          req.get("index"))
                elif self.path == "/reload":
                    if "corpus" in req:
                        new_corpus = list(req["corpus"])
                    else:
                        with open(req["path"], encoding="utf-8") as f:
                            new_corpus = [ln.rstrip("\n") for ln in f]
                    out = service.reload(new_corpus)
                elif self.path == "/extract":
                    out = service.extract(
                        req["query"], req.get("scorer", "levenshtein"),
                        int(req.get("limit", 5)), score_cutoff=cutoff,
                        with_editops=bool(req.get("with_editops")))
                else:
                    return self._reply(404, {"error": "unknown path"})
                self._reply(200, out)
            except Exception as e:          # noqa: BLE001 — serve errors
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", required=True,
                    help="text file, one corpus string per line")
    ap.add_argument("--metric", default="levenshtein")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8947)
    ap.add_argument("--bucket", type=int, default=None)
    ap.add_argument("--auto-bucket", action="store_true",
                    help="split mixed-length corpora into per-length-"
                         "class device scanners (BucketedScanner)")
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. 'cpu'); default: the "
                         "process default (the GPU when there is one)")
    ap.add_argument("--warmup", choices=("basic", "full"), default="basic",
                    help="routes to precompile before binding the port: "
                         "'basic' = the plain distances scan; 'full' also "
                         "compiles the cutoff/top-k/scan_many routes")
    args = ap.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    # $JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache: a warm cache
    # turns cold compiles into loads across restarts
    cache = compile_cache.enable()

    with open(args.corpus, encoding="utf-8") as f:
        corpus = [line.rstrip("\n") for line in f]
    service = ScanService(corpus, metric=args.metric, bucket=args.bucket,
                          auto_bucket=args.auto_bucket)
    # warm up in the MAIN thread: backend init + the scan programs'
    # compiles happen before requests arrive
    t0 = time.perf_counter()
    table = service.warmup(full=args.warmup == "full")
    print(json.dumps({"warmup": table,
                      "warmup_seconds": round(time.perf_counter() - t0, 3),
                      "compile_cache": cache}), flush=True)
    server = make_server(service, args.host, args.port)
    print(json.dumps({"serving": True, "host": server.server_address[0],
                      "port": server.server_address[1], "n": service.scanner.n}),
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
