"""Structured word-boundary conformance sweep (device vs C++ oracle).

Every metric's device path crosses u32-word boundaries at pattern
lengths 32/64/96/128; this sweeps all length pairs from
{0,1,2,31,32,33,63,64,65,95,96,97,127,128,129} x two alphabets (ASCII
and Cyrillic) through the DEVICE scalar backend and compares against
the oracle — the systematic complement to the stochastic fuzzer
(``tools/fuzz.py``).

Run: RAPIDFUZZ_TPU_SCALAR_BACKEND=device python tools/boundary_sweep.py
(CPU: ~70 s; exits 1 on any mismatch.)
"""

import itertools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    # default CPU; SWEEP_PLATFORM=gpu opts into the card
    jax.config.update("jax_platforms",
                      os.environ.get("SWEEP_PLATFORM", "cpu"))
    os.environ.setdefault("RAPIDFUZZ_TPU_SCALAR_BACKEND", "device")

    from rapidfuzz_tpu import common, oracle
    from rapidfuzz_tpu.distance import (damerau_levenshtein as dl, hamming,
                                        indel, jaro, jaro_winkler as jw,
                                        lcs_seq, levenshtein as lev, osa,
                                        postfix, prefix)
    assert common.scalar_backend() == "device", common.scalar_backend()

    rng = np.random.default_rng(int(os.environ.get("SWEEP_SEED", 123)))
    lens = [0, 1, 2, 31, 32, 33, 63, 64, 65, 95, 96, 97, 127, 128, 129]
    t0 = time.time()
    bad = 0
    for l1, l2 in itertools.product(lens, lens):
        for alo, ahi in [(97, 101), (0x400, 0x40A)]:
            a = rng.integers(alo, ahi, l1).astype(np.int64)
            b = rng.integers(alo, ahi, l2).astype(np.int64)
            checks = [
                ("lev", lev.distance(a, b),
                 oracle.levenshtein_uniform(a, b)),
                ("w123", lev.distance(a, b,
                                      weights=lev.WeightTable(1, 2, 3)),
                 oracle.levenshtein_weighted(a, b, 1, 2, 3)),
                ("indel", indel.distance(a, b), oracle.indel(a, b)),
                ("lcs", lcs_seq.similarity(a, b), oracle.lcs_seq(a, b)),
                ("osa", osa.distance(a, b), oracle.osa(a, b)),
                ("dl", dl.distance(a, b), oracle.damerau(a, b)),
                ("jaro", jaro.similarity(a, b), oracle.jaro(a, b)),
                ("jw", jw.similarity(a, b, prefix_weight=0.15),
                 oracle.jaro_winkler(a, b, 0.15)),
                ("prefix", prefix.similarity(a, b),
                 oracle.prefix_sim(a, b)),
                ("postfix", postfix.similarity(a, b),
                 oracle.postfix_sim(a, b)),
            ]
            if l1 == l2:
                checks.append(("hamming", hamming.distance(a, b),
                               oracle.hamming(a, b)))
            for name, got, exp in checks:
                ok = (abs(got - exp) < 1e-12 if isinstance(exp, float)
                      else got == exp)
                if not ok:
                    bad += 1
                    print(f"MISMATCH {name} l1={l1} l2={l2} alpha={alo} "
                          f"got={got} exp={exp}", flush=True)
    print(f"boundary sweep done in {time.time() - t0:.0f}s, bad = {bad}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
