"""SemanticKITTI: label taxonomy, range projection and the raw-scan
reader (copies of `taseg_tpu/data/semantickitti/`)."""
