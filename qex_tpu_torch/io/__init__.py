"""Port of qex_tpu.io."""
