"""sabench: the end-to-end benchmark of stringsearch_torch on NVIDIA H100s.

    python -m sabench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` once and prints one JSON line. The
harness is driven by data: a cell names a configuration
(`sabench/configs/<name>.json`, whose `generator` names
`sabench/generators/<generator>.py`) and a traffic mix
(`sabench/traffic/<name>.json`, whose `kind` names
`sabench/kinds/<kind>.py`); an end-to-end metric is read by
`sabench/metrics/<name>.py` and a per-layer one by
`sabench/layers/<name>.py`. A new cell, configuration, mix or metric is a
new file and a new entry, never an edit. A cell runs on the cards its
`chips` asks for (cuda:0 and on); a kind that uses more than one takes
them from `ctx.devices`, and the result reports each card's peak and
busy time beside the fullest card's peak and the mean busy time.

The yardstick lives here and nowhere in the program: the text
generators, the plain reference that decides `correct`
(`sabench/reference.py`, which imports nothing of the program), the table
of peaks and byte bounds (`sabench/peaks.py`) and the reading of the
profiler's trace (`sabench/trace.py`). Nothing here imports jax or the JAX
package.
"""
