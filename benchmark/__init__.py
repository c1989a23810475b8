"""The benchmark of hoisdf_torch on an NVIDIA H100 (``BENCHMARK.json`` at the
repository's root names its cells; ``python -m benchmark.run`` runs one)."""
