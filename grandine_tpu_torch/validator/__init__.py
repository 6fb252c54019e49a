"""Validator-side duties of the port (counterpart of grandine_tpu/validator)."""
