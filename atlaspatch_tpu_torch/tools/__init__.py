"""Command-line tools: weight conversion and preflight, the synthetic annotated corpus, and the measurement scripts for the port's kernels."""
