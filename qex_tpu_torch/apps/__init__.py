"""Port of qex_tpu.apps."""
