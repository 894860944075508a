"""Models of the port (counterpart of `taseg_tpu.models`)."""
