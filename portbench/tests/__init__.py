"""CPU tests of the benchmark at a small size, and its card tests (``-m cuda``)."""
