"""Bring-up check on NVIDIA GPUs: the corpus scan and the top-k service.

One process, phases in order (any failure exits non-zero; nothing is
caught):

1. device: JAX must report GPUs (no CPU fallback); the card's name and
   power limit come from ``nvidia-smi`` in a child process; the C++ oracle
   builds.
2. main path: a 1,048,576-line printable-ASCII corpus (lengths uniform in
   8..64, bucket 64) made from ``--seed``; per metric (levenshtein, indel)
   a ``CorpusScanner`` answers ``distances``, ``distances`` with
   ``score_cutoff=8``, ``topk(k=10)`` and ``scan_many`` of 16 queries with
   ``k=10``.  Every row equals the scanner's XLA route and the C++ oracle;
   every top-k id equals the oracle's (distance, index) order.
3. kernel vs XLA: the scan kernel against the XLA ops, end to end through
   ``CorpusScanner.distances`` at 1M candidates, buckets 32/64/128, in
   turns (A B B A); the kernel route must be the faster one at 64.
4. serve: ``ScanService`` over the levenshtein corpus, ``warmup(full=True)``
   with no error entry, 8 ``/topk`` and 2 ``/distances`` requests over HTTP
   on 127.0.0.1 equal to direct scanner calls.
5. conformance: ``tools/hw_conformance.py``'s checks, every metric through
   the scanner against the oracle.
6. the tests marked ``gpu``.

``--four-cards`` runs phase 1 and, instead of 2-6, a sharded scan of a
4M-line corpus over a 4-device mesh compared with a one-device scanner in
the same process.

    python chip_smoke.py [--seed N] [--four-cards]

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD = ""          # "<name>, <power limit>" from nvidia-smi
MAIN_LINES = 1 << 20         # the main path's corpus (and phase 3's)
FOUR_CARD_LINES = 4 << 20    # the sharded corpus of --four-cards


def log(msg: str) -> None:
    print(f"[{CARD}] {msg}" if CARD else msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def phase(name: str):
    log(f"== {name}")
    return time.perf_counter()


def per_call_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` (whose result is host data, so the device
    work has finished) after one warm call."""
    fn()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    return 1e3 * float(np.median(ts))


# ----------------------------------------------------------------- data


def make_corpus(n: int, width: int, seed: int):
    """``n`` printable-ASCII lines, lengths uniform in 8..width."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, width + 1, n)
    buf = rng.integers(32, 127, (n, width), dtype=np.uint8).tobytes()
    lines = [buf[i * width: i * width + int(k)].decode("ascii")
             for i, k in enumerate(lens)]
    return lines, lens


def make_queries(lines, lens, width: int, seed: int, count: int):
    """``count`` queries: mutated corpus lines (so top-k holds near
    matches), one of full width first."""
    rng = np.random.default_rng(seed + 1)
    full = np.flatnonzero(lens == width)
    picks = [int(full[0])] + [int(i) for i in
                              rng.integers(0, len(lines), count - 1)]
    out = []
    for i in picks:
        s = bytearray(lines[i].encode("ascii"))
        for _ in range(3):
            s[int(rng.integers(0, len(s)))] = int(rng.integers(32, 127))
        out.append(s.decode("ascii"))
    return out


class Oracle:
    """C++ oracle distances of a query against the whole corpus."""

    def __init__(self, lines, lens):
        from rapidfuzz_tpu import oracle

        self.o = oracle
        self.flat = np.frombuffer("".join(lines).encode("ascii"),
                                  np.uint8).astype(np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(lens)]).astype(
            np.int64)

    def __call__(self, metric: str, q: str) -> np.ndarray:
        fn = (self.o.levenshtein_uniform_1vN if metric == "levenshtein"
              else self.o.indel_1vN)
        qe = np.frombuffer(q.encode("ascii"), np.uint8).astype(np.int64)
        return fn(qe, self.flat, self.offsets)


def oracle_topk(d: np.ndarray, k: int) -> np.ndarray:
    """Ids of the k smallest distances, ties by corpus index."""
    part = np.argpartition(d, k - 1)[:k]
    cand = np.flatnonzero(d <= d[part].max())
    return cand[np.lexsort((cand, d[cand]))][:k]


# --------------------------------------------------------------- phases


def phase_device(want: int | None):
    import jax

    devs = jax.devices()
    check(devs and devs[0].platform == "gpu",
          f"no GPU: JAX reports {devs[0].platform if devs else 'nothing'}")
    if want is not None:
        check(len(devs) >= want, f"need {want} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    for line in smi.splitlines():
        print(line, flush=True)
    global CARD
    CARD = smi.splitlines()[0].strip()
    t0 = phase("device")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind} "
        f"({devs[0].platform})")
    from rapidfuzz_tpu import oracle
    from rapidfuzz_tpu.utils import compile_cache

    log(f"compile cache: {compile_cache.enable()}")
    t = time.perf_counter()
    oracle._load()
    log(f"oracle built/loaded in {time.perf_counter() - t:.3f} s")
    check(oracle.levenshtein_uniform([1, 2, 3], [1, 3]) == 1, "oracle")
    log(f"device phase {time.perf_counter() - t0:.3f} s")
    return devs


def phase_main(seed: int):
    from rapidfuzz_tpu.parallel import CorpusScanner

    t0 = phase("main path: 1M x 64 corpus, levenshtein + indel")
    n, width = MAIN_LINES, 64
    lines, lens = make_corpus(n, width, seed)
    queries = make_queries(lines, lens, width, seed, 17)
    q, group = queries[0], queries[1:]
    orc = Oracle(lines, lens)
    log(f"corpus generated in {time.perf_counter() - t0:.3f} s "
        f"({n} lines, {int(lens.sum())} chars)")
    scanners = {}
    for metric in ("levenshtein", "indel"):
        t = time.perf_counter()
        sc = CorpusScanner(lines, metric=metric)
        build = time.perf_counter() - t
        check(sc._kernel, f"{metric}: kernel route not taken on GPU")
        t = time.perf_counter()
        d = sc.distances(q)
        first = time.perf_counter() - t
        log(f"{metric} set-up: build (encode, upload, pack) {build:.3f} s, "
            f"first distances (compile) {first:.3f} s")
        xla = CorpusScanner(lines, metric=metric, force_xla=True)
        check(not xla._kernel, "force_xla")
        dx = np.asarray(xla.distances(q))
        do = orc(metric, q)
        check(np.array_equal(d, dx), f"{metric}: kernel != XLA route")
        check(np.array_equal(d, do), f"{metric}: kernel != oracle")
        log(f"{metric} distances: all {n} rows == XLA route == oracle")

        r = sc.distances(q, score_cutoff=8)
        rx = xla.distances(q, score_cutoff=8)
        check(np.array_equal(r.valid, do <= 8)
              and np.array_equal(r.values[r.valid], do[do <= 8])
              and np.array_equal(r.valid, rx.valid)
              and np.array_equal(r.values[r.valid], rx.values[rx.valid]),
              f"{metric}: cutoff mask")
        log(f"{metric} cutoff 8: {int(r.valid.sum())} valid rows == XLA "
            f"route == oracle")

        v, ids = sc.topk(q, 10)
        exp = oracle_topk(do, 10)
        check(np.array_equal(ids, exp) and np.array_equal(v, do[exp]),
              f"{metric}: topk ids/values != oracle")
        vx, _ = xla.topk(q, 10)
        check(np.array_equal(np.asarray(vx), v), f"{metric}: XLA topk")
        log(f"{metric} topk(10): ids == oracle order, values "
            f"{[int(x) for x in v]}")

        gv, gi = sc.scan_many(group, k=10)
        for j, qq in enumerate(group):
            dq = orc(metric, qq)
            e = oracle_topk(dq, 10)
            check(np.array_equal(gi[j], e) and np.array_equal(gv[j], dq[e]),
                  f"{metric}: scan_many query {j} != oracle")
        log(f"{metric} scan_many(16, k=10): every id == oracle order")

        calls = {
            "distances": (lambda: sc.distances(q), 1),
            "distances_cutoff8": (lambda: sc.distances(q, score_cutoff=8),
                                  1),
            "topk10": (lambda: sc.topk(q, 10), 1),
            "scan_many16_k10": (lambda: sc.scan_many(group, k=10), 16),
        }
        for name, (fn, nq) in calls.items():
            ms = per_call_ms(fn, 5)
            log(f"{metric} {name}: {ms:.3f} ms/call, "
                f"{nq * n / (ms * 1e-3):.4g} pairs/s")
        scanners[metric] = sc
        del xla
    log(f"main path phase {time.perf_counter() - t0:.3f} s")
    return lines, lens, queries, scanners


def phase_kernel_vs_xla(seed: int, lines64, q64, scanners64):
    import jax

    from rapidfuzz_tpu.ops import lcs as lcs_ops
    from rapidfuzz_tpu.ops import levenshtein as lev_ops
    from rapidfuzz_tpu.ops import scan_kernel as sk
    from rapidfuzz_tpu.parallel import CorpusScanner
    from rapidfuzz_tpu.utils import codec

    t0 = phase("kernel vs XLA: 1M candidates, buckets 32/64/128, A B B A")
    n = MAIN_LINES
    for width in (32, 64, 128):
        if width == 64:
            lines, q = lines64, q64
        else:
            lines, lens = make_corpus(n, width, seed + width)
            q = make_queries(lines, lens, width, seed + width, 1)[0]
        for metric in ("levenshtein", "indel"):
            ks = (scanners64[metric] if width == 64
                  else CorpusScanner(lines, metric=metric))
            xs = CorpusScanner(lines, metric=metric, force_xla=True)
            check(ks._kernel and not xs._kernel, "routes")
            check(np.array_equal(ks.distances(q), xs.distances(q)),
                  f"{metric} {width}: kernel != XLA route")
            a1 = per_call_ms(lambda: ks.distances(q), 5)
            b1 = per_call_ms(lambda: xs.distances(q), 5)
            b2 = per_call_ms(lambda: xs.distances(q), 5)
            a2 = per_call_ms(lambda: ks.distances(q), 5)
            ka, xa = (a1 + a2) / 2, (b1 + b2) / 2
            log(f"{metric} bucket {width} (W={width // 32}): kernel "
                f"{a1:.3f}/{a2:.3f} ms, XLA {b1:.3f}/{b2:.3f} ms per "
                f"distances call -> kernel {xa / ka:.2f}x")
            if width == 64:
                check(ka < xa, f"{metric}: the kernel route is not the "
                      "faster one at bucket 64")
            # device time alone: the kernel (with its corpus-order gather)
            # against the jitted XLA op on the same corpus, unchunked
            qe = ks._encode_query(q)
            mode = sk.pick_mode(qe, ks._cmax)
            op = jax.jit(lev_ops.uniform_distance if metric == "levenshtein"
                         else lcs_ops.lcs_similarity)
            qc, ql = codec.pad_batch([qe])
            chars, lens = xs._xla_corpus

            def kern():
                return jax.block_until_ready(ks._kernel_scan([qe], mode))

            def xop():
                return jax.block_until_ready(op(qc, ql, chars, lens))
            c1, d1, d2, c2 = (per_call_ms(kern, 5), per_call_ms(xop, 5),
                              per_call_ms(xop, 5), per_call_ms(kern, 5))
            log(f"{metric} bucket {width} device only: kernel "
                f"{c1:.3f}/{c2:.3f} ms, jit({op.__wrapped__.__name__}) "
                f"{d1:.3f}/{d2:.3f} ms -> kernel "
                f"{(d1 + d2) / (c1 + c2):.2f}x")
            del xs, chars
    log(f"kernel vs XLA phase {time.perf_counter() - t0:.3f} s")


def phase_serve(lines, queries, scanner):
    from rapidfuzz_tpu.serve import ScanService, make_server

    t0 = phase("serve: ScanService over the levenshtein corpus, HTTP")
    t = time.perf_counter()
    service = ScanService(lines, metric="levenshtein")
    log(f"service build {time.perf_counter() - t:.3f} s")
    table = service.warmup(full=True)
    log(f"warmup table {json.dumps(table)}")
    check(all(not isinstance(v, str) for v in table.values()),
          f"warmup error entries: {table}")
    server = make_server(service, "127.0.0.1", 0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()

    def post(path, obj):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        for q in queries[:8]:
            t = time.perf_counter()
            got = post("/topk", {"query": q, "k": 10})
            ms = 1e3 * (time.perf_counter() - t)
            v, ids = scanner.topk(q, 10)
            check(got["values"] == [int(x) for x in v]
                  and got["indices"] == [int(i) for i in ids]
                  and got["strings"] == [lines[i] for i in ids],
                  f"/topk {q!r} != scanner")
            log(f"/topk k=10: {ms:.3f} ms over HTTP, == scanner")
        for q in queries[8:10]:
            t = time.perf_counter()
            got = post("/distances", {"query": q})
            ms = 1e3 * (time.perf_counter() - t)
            check(np.array_equal(np.asarray(got["values"]),
                                 scanner.distances(q)),
                  f"/distances {q!r} != scanner")
            log(f"/distances ({len(got['values'])} values): {ms:.3f} ms "
                "over HTTP, == scanner")
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)
    log(f"serve phase {time.perf_counter() - t0:.3f} s")


def phase_conformance():
    t0 = phase("conformance: tools/hw_conformance.py, every metric vs oracle")
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import hw_conformance

    hw_conformance.run(log=log)
    log(f"conformance phase {time.perf_counter() - t0:.3f} s")


def phase_gpu_tests():
    t0 = phase("tests marked gpu")
    import pytest

    os.environ["RAPIDFUZZ_TPU_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(ROOT, "tests")])
    check(rc == 0, f"gpu tests: pytest exit code {int(rc)}")
    log(f"gpu tests phase {time.perf_counter() - t0:.3f} s")


def phase_four_cards(devs, seed: int):
    from jax.sharding import Mesh

    from rapidfuzz_tpu.parallel import CorpusScanner

    t0 = phase("four cards: 4M-line corpus, 4-device mesh vs one device")
    n, width = FOUR_CARD_LINES, 64
    lines, lens = make_corpus(n, width, seed)
    queries = make_queries(lines, lens, width, seed, 17)
    q, group = queries[0], queries[1:]
    mesh4 = Mesh(np.array(devs[:4]), ("data",))
    mesh1 = Mesh(np.array(devs[:1]), ("data",))
    for metric in ("levenshtein", "indel"):
        t = time.perf_counter()
        s4 = CorpusScanner(lines, metric=metric, mesh=mesh4)
        b4 = time.perf_counter() - t
        s1 = CorpusScanner(lines, metric=metric, mesh=mesh1)
        check(s4._kernel and s1._kernel and s4._ndev == 4, "routes")
        check(np.array_equal(s4.distances(q), s1.distances(q)),
              f"{metric}: sharded distances != one device")
        v4, i4 = s4.topk(q, 10)
        v1, i1 = s1.topk(q, 10)
        check(np.array_equal(v4, v1) and np.array_equal(i4, i1),
              f"{metric}: sharded topk != one device")
        g4 = s4.scan_many(group, k=10)
        g1 = s1.scan_many(group, k=10)
        check(np.array_equal(g4[0], g1[0]) and np.array_equal(g4[1], g1[1]),
              f"{metric}: sharded scan_many != one device")
        m4 = per_call_ms(lambda: s4.distances(q), 5)
        m1 = per_call_ms(lambda: s1.distances(q), 5)
        log(f"{metric}: distances, topk(10), scan_many(16, k=10) identical "
            f"on 4 devices and 1; build {b4:.3f} s; distances {m4:.3f} ms "
            f"(4 devices) vs {m1:.3f} ms (1 device), {n} lines")
        del s4, s1
    log(f"four-card phase {time.perf_counter() - t0:.3f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device sharded phase")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    devs = phase_device(4 if args.four_cards else None)
    if args.four_cards:
        phase_four_cards(devs, args.seed)
        count = 4
    else:
        lines, lens, queries, scanners = phase_main(args.seed)
        phase_kernel_vs_xla(args.seed, lines, queries[0], scanners)
        phase_serve(lines, queries, scanners["levenshtein"])
        del scanners["indel"]
        phase_conformance()
        phase_gpu_tests()
        count = len(devs)
    log(f"total {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
