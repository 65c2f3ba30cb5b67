"""Port of qex_tpu.models: the XY and Z_N clock spin models and compact
U(1) gauge theory in the angle representation."""
