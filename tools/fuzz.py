"""Differential fuzzer: device batch paths vs the scalar/oracle path.

The reference ships six cargo-fuzz/libFuzzer targets that throw
arbitrary UTF-8 at one-shot + BatchComparator and rely on the library's
internal assertions (``/root/reference/fuzz/fuzz_targets/*.rs``).  This
is this library's analogue as a standalone tool: mutation-based
generation from a seed corpus, every metric checked FOUR ways per input
(scalar(a,b), scalar(b,a), batch one-vs-many, cutoff-masked batch)
against the C++ oracle, failures shrunk to minimal reproducers.

Run:  python tools/fuzz.py [--seconds 60] [--seed 0] [--metric lev ...]
CI runs a short budget (see .github/workflows/ci.yml); longer local runs
explore further.  Exit code 1 on any divergence, printing a paste-able
reproducer.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def _pick_platform():
    # default CPU: the differential properties are platform-independent.
    # Opt into the GPU with FUZZ_PLATFORM=gpu.
    import jax
    jax.config.update("jax_platforms",
                      os.environ.get("FUZZ_PLATFORM", "cpu"))


SEEDS = [
    "", "a", "ab", "ba", "abc", "kitten", "sitting", "aaaa", "aaab",
    "CA", "ABC", "Иванко", "Петрунко", "不丁丙", "001", "220",
    "this is a test", "a" * 33, "ab" * 40, "￿\U0010ffff",
]

ALPHABETS = [
    list("ab"), list("abcdefgh"),
    [chr(c) for c in range(0x400, 0x420)],          # Cyrillic
    [chr(c) for c in (0x4e0d, 0x4e01, 0x4e19, 0x61, 0x20)],  # CJK + ascii
    [chr(c) for c in (0x1F600, 0x1F601, 0x61)],     # astral plane
]


def mutate(rng: random.Random, s: str) -> str:
    ops = rng.randint(1, 4)
    out = list(s)
    alpha = rng.choice(ALPHABETS)
    for _ in range(ops):
        k = rng.randint(0, 5)
        if k == 0 and out:
            del out[rng.randrange(len(out))]
        elif k == 1:
            out.insert(rng.randint(0, len(out)), rng.choice(alpha))
        elif k == 2 and out:
            out[rng.randrange(len(out))] = rng.choice(alpha)
        elif k == 3 and len(out) >= 2:
            i = rng.randrange(len(out) - 1)
            out[i], out[i + 1] = out[i + 1], out[i]
        elif k == 4:
            out = out + list(rng.choice(SEEDS))
        else:
            i = rng.randint(0, len(out))
            out = out[:i] + list(reversed(out[i:]))
    return "".join(out[:300])


def check_pair(mod_name: str, s1: str, s2: str) -> str | None:
    """Return a divergence description or None."""
    from rapidfuzz_tpu.distance import (damerau_levenshtein, hamming,
                                        indel, jaro, jaro_winkler, lcs_seq,
                                        levenshtein, osa, postfix, prefix)
    mods = dict(levenshtein=levenshtein, indel=indel, lcs_seq=lcs_seq,
                osa=osa, damerau_levenshtein=damerau_levenshtein,
                jaro=jaro, jaro_winkler=jaro_winkler, prefix=prefix,
                postfix=postfix, hamming=hamming)
    mod = mods[mod_name]
    kw = {"pad": True} if mod_name == "hamming" else {}
    f64 = mod_name in ("jaro", "jaro_winkler")
    tol = 1e-9 if f64 else 0

    d12 = mod.distance(s1, s2, **kw)
    d21 = mod.distance(s2, s1, **kw)
    if abs(d12 - d21) > tol:
        return f"symmetry: {d12} vs {d21}"
    batch = mod.distance_many([s1], [s2], **kw).values[0]
    if abs(batch - d12) > tol:
        return f"batch != scalar: {batch} vs {d12}"
    # cutoff mask agrees with the scalar Option semantics, straddling d12
    for cut in ({max(0.0, d12 - 1), d12, d12 + 1} if f64
                else {max(0, int(d12) - 1), int(d12), int(d12) + 1}):
        got = mod.distance(s1, s2, score_cutoff=cut, **kw)
        res = mod.distance_many([s1], [s2], score_cutoff=cut, **kw)
        want = d12 if d12 <= cut + (1e-12 if f64 else 0) else None
        got_b = res.values[0] if res.valid[0] else None
        if (got is None) != (want is None) or (got_b is None) != (want is None):
            return f"cutoff {cut}: scalar {got}, batch {got_b}, want {want}"
    # normalized similarity in range + consistent
    ns = mod.normalized_similarity(s1, s2, **kw)
    if not (0.0 - 1e-12 <= ns <= 1.0 + 1e-12):
        return f"normalized_similarity out of range: {ns}"
    # editops replay (alignment metrics only)
    if mod_name in ("levenshtein", "indel", "lcs_seq") and len(s1) < 200 \
            and len(s2) < 200:
        ops = mod.editops(s1, s2)
        if mod_name == "levenshtein" and len(ops) != d12:
            return f"editops length {len(ops)} != distance {d12}"
        if ops.apply(s1, s2) != s2:
            return "editops.apply mismatch"
    # score_hint must never change results (levenshtein.rs:1069-1088)
    if not f64 and mod_name != "hamming":
        di = int(d12)
        for hint in (0, di // 2, di, 2 * di + 3):
            h = mod.distance(s1, s2, score_hint=hint, **kw)
            if h != d12:
                return f"hint {hint} changed result: {h} vs {d12}"
    return None


def check_weights(rng: random.Random, s1: str, s2: str) -> str | None:
    """Weighted-Levenshtein properties: transpose symmetry
    d(a,b;i,d,s) == d(b,a;d,i,s), algebraic reductions (uniform scale,
    sub >= ins+del collapses to indel), batch == scalar, cutoff masks."""
    from rapidfuzz_tpu.distance import indel, levenshtein

    # weights are STATIC args to the batch kernels — a compilation per
    # distinct triple.  A fixed pool bounds XLA-CPU's JIT code sections
    # (unbounded random triples exhausted them: "LLVM compilation error:
    # Cannot allocate memory" after a few hundred execs)
    pool = ((1, 1, 2), (2, 1, 3), (0, 2, 2), (3, 3, 3), (1, 2, 0),
            (2, 2, 5), (0, 0, 1), (4, 1, 1))
    ins, dele, sub = pool[rng.randrange(len(pool))]
    w = levenshtein.WeightTable(ins, dele, sub)
    wt = levenshtein.WeightTable(dele, ins, sub)
    d = levenshtein.distance(s1, s2, weights=w)
    dt = levenshtein.distance(s2, s1, weights=wt)
    if d != dt:
        return f"weights transpose: {d} vs {dt} ({ins},{dele},{sub})"
    b = levenshtein.distance_many([s1], [s2], weights=w).values[0]
    if int(b) != d:
        return f"weights batch != scalar: {b} vs {d}"
    if ins == dele:
        if ins == sub and ins > 0:
            u = levenshtein.distance(s1, s2)
            if d != ins * u:
                return f"uniform scale: {d} != {ins} * {u}"
        if sub >= ins + dele and ins > 0:
            idl = indel.distance(s1, s2)
            if d != ins * idl:
                return f"indel reduction: {d} != {ins} * {idl}"
    for cut in (max(0, d - 1), d, d + 1):
        got = levenshtein.distance(s1, s2, weights=w, score_cutoff=cut)
        want = d if d <= cut else None
        if got != want:
            return f"weights cutoff {cut}: {got} vs {want}"
    return None


def check_cross_metric(s1: str, s2: str) -> str | None:
    """Inter-metric orderings that hold for every pair:
    damerau <= osa <= levenshtein <= indel, max-lcs distance <=
    levenshtein, jaro-family in [0, 1]."""
    from rapidfuzz_tpu.distance import (damerau_levenshtein, indel, jaro,
                                        lcs_seq, levenshtein, osa)

    dl = damerau_levenshtein.distance(s1, s2)
    do = osa.distance(s1, s2)
    dv = levenshtein.distance(s1, s2)
    di = indel.distance(s1, s2)
    dc = lcs_seq.distance(s1, s2)
    if not dl <= do <= dv <= di:
        return f"ordering: dam {dl} osa {do} lev {dv} indel {di}"
    if dc > dv:
        return f"lcs distance {dc} > levenshtein {dv}"
    j = jaro.similarity(s1, s2)
    if not -1e-12 <= j <= 1 + 1e-12:
        return f"jaro out of range: {j}"
    return None


def shrink(mod_name: str, s1: str, s2: str) -> tuple[str, str]:
    """Greedy chunk-removal shrink keeping the divergence alive."""
    def still_fails(a, b):
        try:
            return check_pair(mod_name, a, b) is not None
        except Exception:
            return True

    changed = True
    while changed:
        changed = False
        for which in (0, 1):
            s = s1 if which == 0 else s2
            n = len(s)
            step = max(1, n // 4)
            while step:
                i = 0
                while i < len(s):
                    cand = s[:i] + s[i + step:]
                    a, b = (cand, s2) if which == 0 else (s1, cand)
                    if still_fails(a, b):
                        s = cand
                        changed = True
                    else:
                        i += step
                step //= 2
            if which == 0:
                s1 = s
            else:
                s2 = s
    return s1, s2


def check_scanner(rng: random.Random, corpus: list) -> str | None:
    """Differential check of the CorpusScanner routing layer (bucketing,
    length sort, cutoff masks, top-k) against the scalar API."""
    from rapidfuzz_tpu import fuzz as fuzz_mod
    from rapidfuzz_tpu.parallel.scan import CorpusScanner
    from rapidfuzz_tpu.distance import (damerau_levenshtein, indel, jaro,
                                        lcs_seq, levenshtein, osa)
    mods = dict(levenshtein=levenshtein, indel=indel, lcs_seq=lcs_seq,
                osa=osa, damerau_levenshtein=damerau_levenshtein,
                jaro=jaro, partial_ratio=None)
    name = rng.choice(list(mods))
    mod = mods[name]
    sample = [rng.choice(corpus) for _ in range(rng.randint(1, 24))]
    q = mutate(rng, rng.choice(sample))
    f64 = name in ("jaro", "partial_ratio")
    tol = 1e-9 if f64 else 0

    def scalar(a, b, cutoff=None):
        if name == "partial_ratio":
            # scanner yields distance = 1 - best-window ratio; reference
            # is the INDEPENDENT C++ brute-force oracle
            from rapidfuzz_tpu import oracle as _oracle
            from rapidfuzz_tpu.utils import codec as _codec
            s = _oracle.partial_ratio(_codec.encode_one(a),
                                      _codec.encode_one(b))
            d = 1.0 - s
            if cutoff is not None and d > cutoff + 1e-12:
                return None
            return d
        return mod.distance(a, b, **({} if cutoff is None
                                     else dict(score_cutoff=cutoff)))

    try:
        sc = CorpusScanner(sample, metric=name)
        d = sc.distances(q)
        for s, g in zip(sample, d):
            exp = scalar(q, s)
            if abs(float(g) - exp) > tol:
                return (f"scanner[{name}] {g} != scalar {exp} "
                        f"for q={q!r} s={s!r}")
        cut = float(d[0]) if f64 else int(d[0])
        res = sc.distances(q, score_cutoff=cut)
        for s, v, ok in zip(sample, res.values, res.valid):
            exp = scalar(q, s, cutoff=cut)
            if ok != (exp is not None) or (ok and abs(v - exp) > tol):
                return (f"scanner[{name}] cutoff {cut}: ({v}, {ok}) vs "
                        f"{exp} for q={q!r} s={s!r}")
        if not f64:
            # small-cutoff probe: integer metrics route banded kernels
            # here (lev/indel band words, damerau |i-j| <= k band) —
            # keep this dimension hot in every campaign
            cut2 = rng.randint(0, 15)
            res2 = sc.distances(q, score_cutoff=cut2)
            for s, v, ok in zip(sample, res2.values, res2.valid):
                exp = scalar(q, s, cutoff=cut2)
                if ok != (exp is not None) or (ok and abs(v - exp) > tol):
                    return (f"scanner[{name}] cutoff {cut2}: ({v}, {ok})"
                            f" vs {exp} for q={q!r} s={s!r}")
        vals, ids = sc.topk(q, k=3)
        base = sorted(
            (scalar(q, s), i) for i, s in enumerate(sample))
        if len(vals) and abs(float(vals[0]) - base[0][0]) > tol:
            return (f"scanner[{name}] topk {vals[0]} != best "
                    f"{base[0][0]} for q={q!r}")
        # grouped multi-query dispatches must equal per-query scans
        if sc._nq_eligible():
            q2 = mutate(rng, q)
            import numpy as _np
            dm = _np.asarray(sc.scan_many([q, q2]))
            if abs(dm[0] - _np.asarray(d, _np.float64)).max() > tol:
                return f"scanner[{name}] scan_many[0] != distances q={q!r}"
            d2 = _np.asarray(sc.distances(q2), _np.float64)
            if abs(dm[1] - d2).max() > tol:
                return f"scanner[{name}] scan_many[1] != distances q={q2!r}"
    except Exception as e:
        return f"scanner[{name}] exception: {type(e).__name__}: {e}"
    return None


def check_editops(rng: random.Random, corpus: list) -> str | None:
    """editops/editops_many: minimality (len == distance), replay
    (apply reconstructs the destination), batch == pairwise."""
    from rapidfuzz_tpu.distance import indel, levenshtein

    sample = [rng.choice(corpus) for _ in range(rng.randint(1, 8))]
    q = mutate(rng, rng.choice(sample))
    if max(len(q), max(len(s) for s in sample)) > 4000:
        return None     # recording cap (documented ValueError)
    try:
        many = levenshtein.editops_many(q, sample)
        for s, ops in zip(sample, many):
            if len(ops) != levenshtein.distance(q, s):
                return (f"editops len {len(ops)} != distance for "
                        f"q={q!r} s={s!r}")
            if ops.apply(q, s) != s:
                return f"editops apply mismatch q={q!r} s={s!r}"
            if list(ops) != list(levenshtein.editops(q, s)):
                return f"editops_many != pairwise q={q!r} s={s!r}"
        iops = indel.editops_many(q, sample)
        for s, ops in zip(sample, iops):
            if len(ops) != indel.distance(q, s) or ops.apply(q, s) != s:
                return f"indel editops mismatch q={q!r} s={s!r}"
    except Exception as e:
        return f"editops exception: {type(e).__name__}: {e}"
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metric", action="append", default=None)
    ap.add_argument("--scanner-every", type=int, default=0,
                    help="also fuzz the CorpusScanner routing layer every "
                         "N executions (0 = off; scanner builds are "
                         "slow, use ~200)")
    args = ap.parse_args()

    if args.seconds > 360 and not os.environ.get("FUZZ_CHILD"):
        # XLA:CPU's JIT keeps a code section per compiled shape and a
        # long campaign eventually dies with "Unable to allocate section
        # memory" — so long budgets run as sequential child processes,
        # each with a fresh JIT and a derived seed
        import subprocess
        t_end = time.time() + args.seconds
        i = 0
        while time.time() < t_end - 10:
            chunk = min(300.0, t_end - time.time())
            argv = [sys.executable, "-u", __file__,
                    "--seconds", str(chunk),
                    "--seed", str(args.seed + 1009 * (i + 1)),
                    "--scanner-every", str(args.scanner_every)]
            for m in (args.metric or []):
                argv += ["--metric", m]
            p = subprocess.run(argv,
                               env=dict(os.environ, FUZZ_CHILD="1"))
            if p.returncode:
                sys.exit(p.returncode)
            i += 1
        print(f"ok: campaign finished ({i} fresh-JIT chunks)")
        return

    _pick_platform()
    metrics = args.metric or [
        "levenshtein", "indel", "lcs_seq", "osa", "damerau_levenshtein",
        "jaro", "jaro_winkler", "prefix", "postfix", "hamming"]

    rng = random.Random(args.seed)
    corpus = list(SEEDS)
    deadline = time.time() + args.seconds
    n = 0
    while time.time() < deadline:
        s1 = mutate(rng, rng.choice(corpus))
        s2 = (mutate(rng, s1) if rng.random() < 0.6
              else mutate(rng, rng.choice(corpus)))
        if rng.random() < 0.3:
            corpus.append(s1)
            if len(corpus) > 200:
                corpus.pop(rng.randrange(len(corpus)))
        m = rng.choice(metrics)
        try:
            err = check_pair(m, s1, s2)
            if not err and rng.random() < 0.25 and len(s1) < 300 \
                    and len(s2) < 300:
                err = check_weights(rng, s1, s2)
                m = m if err is None else "weights"
            if not err and rng.random() < 0.15 and len(s1) < 300 \
                    and len(s2) < 300:
                err = check_cross_metric(s1, s2)
                m = m if err is None else "cross_metric"
        except Exception as e:  # crashes are findings too
            err = f"exception: {type(e).__name__}: {e}"
        n += 1
        if not err and args.scanner_every and n % args.scanner_every == 0:
            err = check_scanner(rng, corpus)
            m = "scanner"
        if (not err and args.scanner_every
                and n % (2 * args.scanner_every) == 0):
            err = check_editops(rng, corpus)
            m = "scanner"        # reproducer is in the message itself
        if err:
            if m in ("scanner", "weights", "cross_metric"):
                # reproducer is in the message / the (s1, s2) pair itself
                print(f"FAIL[{m}] after {n} execs: {err}")
                print(f"  pair: ({s1!r}, {s2!r})")
                sys.exit(1)
            s1m, s2m = shrink(m, s1, s2)
            print(f"FAIL[{m}] after {n} execs: {err}")
            print(f"  reproducer: check_pair({m!r}, {s1m!r}, {s2m!r})")
            sys.exit(1)
    print(f"ok: {n} execs, {len(corpus)} corpus entries, "
          f"{len(metrics)} metrics")


if __name__ == "__main__":
    main()
