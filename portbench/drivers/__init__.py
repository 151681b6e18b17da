"""The timed paths of the benchmark, one module per kind (``harness`` says what each
provides)."""
