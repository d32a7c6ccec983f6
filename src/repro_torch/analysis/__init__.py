"""Static checks of the port's kernels (``repro.analysis`` counterpart)."""
