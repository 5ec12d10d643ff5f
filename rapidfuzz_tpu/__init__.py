"""rapidfuzz_tpu — an accelerator-native fuzzy string-matching
framework.

Brand-new JAX/XLA/Pallas design with the capabilities of the
``rapidfuzz-rs`` reference library (see SURVEY.md): the full metric family
with ``score_cutoff``/``score_hint`` semantics, one-vs-many
``BatchComparator`` precomputation, batched many-vs-many scoring, and
data-parallel corpus scans over ``jax.sharding`` meshes.
"""

from . import common  # noqa: F401
from . import distance  # noqa: F401
from . import fuzz  # noqa: F401

__version__ = "0.1.0"
