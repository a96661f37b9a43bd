"""fxbench: the benchmark of ``fxtpu_torch``, the FX correlator in PyTorch
and CUDA.  ``python -m fxbench.run --workload <name> --seed <n> --seconds
<s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Nothing here imports JAX or the JAX package ``fxtpu``; the
reference (``fxbench.reference``) imports nothing of ``fxtpu_torch``.

This file imports nothing, so that ``run.py`` can take the process's start
time before torch loads."""
