"""The benchmark of `msvit_tpu_torch` on one NVIDIA H100.

`run.py` runs one cell of `BENCHMARK.json` once.  Everything a cell is made
of is found by name: its configuration (`configs/`), traffic mix
(`traffic/`, a data file naming one of the `loops/`), correctness limits
(`limits/`) and per-layer metric readers (`metrics/`).  The yardstick lives
here too: operation and byte counts (`flops.py`), the trace reduction
(`trace.py`), seeded weights and inputs (`weights.py`), the comparisons
(`compare.py`) and the plain reference (`reference/`), which shares no code
with the port.  `tools/` holds the knee sweep and the control readings;
`tests/` the CPU tests (`python -m pytest perfbench/tests -q`, the card
runs with `-m cuda`).
"""
