"""Cross-chain pooling (port of ``nuts_rs_tpu/parallel``, one device)."""
