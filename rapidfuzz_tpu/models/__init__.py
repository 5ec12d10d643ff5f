"""High-level scorer workflows built on the batched kernels.

The reference crate ships only the metric modules; rapidfuzz's wider
ecosystem (C++/Python) exposes ``process``-style one-vs-many / many-vs-many
drivers on top of them.  This package provides the device-native
equivalents:
``extract`` / ``extract_one`` (scan + top-k over a corpus) and ``cdist``
(many-vs-many score matrices), all running on the device kernels with
sharded corpora.
"""

from .process import (cdist, extract, extract_editops, extract_iter,  # noqa: F401
                      extract_one)
