"""The tutorials of ``examples/`` as torch programs (ex0, ex1,
harmonic): run each with ``python -m qex_tpu_torch.examples.<name>``."""
