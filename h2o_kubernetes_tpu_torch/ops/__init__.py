"""Hand-written GPU kernels and their plain torch versions."""
