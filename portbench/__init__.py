"""portbench: the benchmark of palettenerf_torch on the H100 (``python3 -m portbench.run``;
see README.md)."""
