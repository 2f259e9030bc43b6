"""The benchmark of ``fusion_tpu_torch`` on NVIDIA GPUs.

Run from the root of a checkout:

    python -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` names the cells; each cell's configuration, traffic mix
and per-layer metric readers are files of their own under this directory
(``configs/``, ``traffic/``, ``metrics/``), found by name.  Everything
that measures (traffic generation, the reduction of traces to metrics, the
table of peaks, the work counts, the plain reference and the comparison
that decides ``correct``) lives here, so that a change to the program
cannot move it.  Nothing under this directory imports JAX or the JAX
package, and ``reference/`` imports nothing of the program.
"""
