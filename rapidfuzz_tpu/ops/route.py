"""Route choice for corpus scans: the Pallas scan kernel or the XLA ops.

One pure function decides, from what a scanner knows when it is built
(and, per query, the query's word count).  The kernel
(:mod:`rapidfuzz_tpu.ops.scan_kernel`) is compiled for NVIDIA GPUs through
Pallas' Triton route; everything else runs the XLA ops of
:mod:`rapidfuzz_tpu.ops`, which compile for any backend.
"""

from __future__ import annotations

from typing import NamedTuple

#: metrics the scan kernel serves (indel and lcs_seq finish from the LCS
#: length on the host side of the kernel)
KERNEL_METRICS = ("levenshtein", "indel", "lcs_seq")
#: widest candidate bucket the kernel is routed for (the bucket sizes the
#: packed corpus the kernel streams; its registers do not grow with it)
KERNEL_MAX_LB = 4096
#: widest query, in 32-bit words, per kernel compilation (the state words
#: live in registers, unrolled per word)
KERNEL_MAX_WORDS = 16
#: queries one kernel program serves in the grouped form: each loaded text
#: word is reused across them, while their state words share the registers
GROUP_WORDS = 8


class Route(NamedTuple):
    kernel: bool   # the Pallas scan kernel; else the XLA ops
    group: int     # queries per kernel program (1 off the grouped form)


def default_platform() -> str:
    """Platform of JAX's default device."""
    import jax

    return jax.devices()[0].platform


def mesh_platform(mesh) -> str:
    """Platform of a mesh's devices ('gpu', 'cpu', ...); a mixed mesh
    reports the first platform it finds that is not 'gpu'."""
    plats = {getattr(d, "platform", "") for d in mesh.devices.flat}
    return "gpu" if plats == {"gpu"} else sorted(plats - {"gpu"})[0]


def pick_route(platform: str, metric: str, bucket: int, *,
               wide: bool = False, weighted: bool = False,
               grouped: bool = False, words: int = 1) -> Route:
    """Route for one scan.

    ``platform``: the mesh's device platform; ``bucket``: the corpus's
    padded candidate length; ``wide``: the corpus holds chars >= 256 (the
    kernel reads bytes); ``weighted``: a general insertion / deletion /
    substitution table (only uniform and scaled-uniform weights reduce to
    the kernel); ``grouped``: several queries share the scan
    (``scan_many``); ``words``: the query's ``ceil(len / 32)``.
    """
    kernel = (platform == "gpu" and metric in KERNEL_METRICS
              and not wide and not weighted
              and bucket <= KERNEL_MAX_LB and words <= KERNEL_MAX_WORDS)
    group = 1
    if kernel and grouped:
        group = max(1, min(4, GROUP_WORDS // words))
    return Route(kernel, group)
