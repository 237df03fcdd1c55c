"""Model metadata helpers (copies of ``blazr_tpu/model_meta``)."""
