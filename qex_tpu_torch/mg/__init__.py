"""Wilson multigrid (port of ``qex_tpu.mg``)."""
