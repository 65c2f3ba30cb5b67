"""Benchmarks of the port (counterpart of ``qex_tpu.bench`` and of
the repository's Dslash generation scripts)."""
