"""uvaia-tpu: accelerator-native reference-based genome alignment and search.

A from-scratch JAX/XLA framework with the capabilities of
quadram-institute-bioscience/uvaia v2.0.2: reference-based WFA-style
alignment, exact nearest-neighbour search over huge aligned databases,
radius search, and canopy clustering — re-designed for a GPU
(dense int8 match-count matmuls, lax.sort top-k, sharded multi-device
scans).
"""

__version__ = "0.5.0"
