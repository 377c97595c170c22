"""See the package docstring of nerfmatch_tpu_torch."""
