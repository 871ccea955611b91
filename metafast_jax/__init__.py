"""metafast-jax: a metagenome comparison engine in JAX.

Reference-free comparison of shotgun metagenomic samples: canonical k-mer
counting, de Bruijn graph construction, connected-component feature
extraction, and Bray-Curtis distance matrices — built with JAX/XLA for
GPUs (32-bit pair k-mer representation, sort + segment-reduce counting,
chain ranking for contigs, label propagation for components).

Functionally equivalent to the MetaFast toolkit (ctlab/metafast) but
architected for SPMD execution over device meshes rather than shared-memory
Java threads.
"""

import os as _os
from pathlib import Path as _Path

import jax as _jax

__version__ = "0.1.0"

# Persistent XLA compilation cache: the counting pipeline uses a bounded
# family of power-of-two shape signatures, so caching them makes every
# process after the first start hot.  JAX_COMPILATION_CACHE_DIR, when set,
# names the directory (JAX reads it itself); otherwise the cache sits at a
# fixed path inside the checkout, because the path is part of the key.
CACHE_DIR = _Path(__file__).resolve().parent.parent / ".jax_cache"
if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    _jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
