"""Correlators and other measurements (port of ``qex_tpu.observables``)."""
