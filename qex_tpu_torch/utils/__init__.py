"""Port of qex_tpu.utils."""
