"""See the package docstring of nuts_rs_tpu_torch."""
