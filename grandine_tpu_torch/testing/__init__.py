"""Test and rehearsal helpers of the port (counterpart of grandine_tpu/testing)."""
