"""Serving layer: HTTP daemon around the device-resident corpus scan."""

import json
import threading
import urllib.error
import urllib.request

from rapidfuzz_tpu.serve import ScanService, make_server
from rapidfuzz_tpu.distance import levenshtein as lev


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def test_warmup_route_table():
    """warmup(full=True) precompiles the corpus's serving routes before
    the port binds and returns the route -> seconds cold-start table
    (the reference's contract is that a library call never compiles;
    the server absorbs compiles at startup)."""
    corpus = ["apple", "apply", "ape", "maple", "orange", "grape", ""]
    service = ScanService(corpus, metric="levenshtein", bucket=32)
    table = service.warmup(full=True)
    assert set(table) == {"distances", "distances_cutoff", "topk",
                          "scan_many"}, table      # longest query: 1 word
    for route, secs in table.items():
        assert isinstance(secs, float), (route, secs)     # no "error: ..."
    # warmed routes answer without error afterwards
    assert service.distances("apple")["values"][0] == 0


def test_scan_service_http():
    corpus = ["apple", "apply", "ape", "maple", "orange", "grape", ""]
    service = ScanService(corpus, metric="levenshtein", bucket=32)
    server = make_server(service, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        h = _get(port, "/health")
        assert h["ok"] and h["n"] == len(corpus)

        out = _post(port, "/topk", {"query": "apple", "k": 3})
        assert out["strings"][0] == "apple" and out["values"][0] == 0
        assert out["values"] == sorted(out["values"])

        out = _post(port, "/distances", {"query": "apple"})
        assert out["values"] == [lev.distance("apple", s) for s in corpus]

        out = _post(port, "/distances", {"query": "apple",
                                         "score_hint": 3})
        assert out["values"] == [lev.distance("apple", s) for s in corpus]

        out = _post(port, "/distances", {"query": "apple",
                                         "score_cutoff": 2})
        masked = [lev.distance("apple", s, score_cutoff=2) for s in corpus]
        for v, ok, exp in zip(out["values"], out["valid"], masked):
            assert ok == (exp is not None)
            if ok:
                assert v == exp

        try:                                        # missing query -> 400
            _post(port, "/topk", {"k": 3})
            raise AssertionError("expected HTTP 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400
            assert "error" in json.loads(e.read())

        st = _get(port, "/stats")
        assert st["queries"] == 4 and st["pairs"] == 4 * len(corpus)

        # /batch rides scan_many (grouped multi-query dispatches)
        out = _post(port, "/batch", {"queries": ["apple", "grape"]})
        assert out["values"][0] == [lev.distance("apple", s)
                                    for s in corpus]
        assert out["values"][1] == [lev.distance("grape", s)
                                    for s in corpus]
        out = _post(port, "/batch", {"queries": ["apple", "grape"], "k": 2})
        assert out["strings"][0][0] == "apple" and out["values"][0][0] == 0
        assert out["strings"][1][0] == "grape" and out["values"][1][0] == 0
        st = _get(port, "/stats")
        assert st["queries"] == 8 and st["pairs"] == 8 * len(corpus)

        # alignment endpoint: pair form and corpus-index form
        out = _post(port, "/editops", {"s1": "kitten", "s2": "sitting"})
        assert out["distance"] == 3
        assert out["editops"][0] == ["replace", 0, 0]
        assert out["opcodes"][-1] == ["insert", 6, 6, 6, 7]
        out = _post(port, "/editops", {"s1": "apples", "index": 0})
        assert out["distance"] == lev.distance("apples", corpus[0])

        # extract endpoint with a fuzz-family scorer
        out = _post(port, "/extract", {"query": "appel", "scorer": "WRatio",
                                       "limit": 2})
        assert out["results"][0][0] in ("apple", "apply")
        assert 0.0 < out["results"][0][1] <= 1.0

        # extract with edit scripts (one batched recording dispatch)
        out = _post(port, "/extract", {"query": "appel", "limit": 2,
                                       "with_editops": True})
        top = out["results"][0]
        assert len(top) == 4
        ops = lev.editops("appel", top[0])
        assert top[3] == [[o.tag, o.src_pos, o.dest_pos] for o in ops]

        # hot corpus reload: atomic swap, old corpus served until then
        out = _post(port, "/reload", {"corpus": ["zebra", "zebu"]})
        assert out == {"ok": True, "n": 2}
        out = _post(port, "/topk", {"query": "zebra", "k": 1})
        assert out["strings"] == ["zebra"] and out["values"][0] == 0
        out = _get(port, "/health")
        assert out["n"] == 2
    finally:
        server.shutdown()
