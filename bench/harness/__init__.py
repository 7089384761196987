"""The general harness: it finds each cell's configuration, traffic mix,
per-cell data and metric readers by name from ``BENCHMARK.json``, and
holds no per-cell code."""
