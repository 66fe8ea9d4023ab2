"""The benchmark of torchrec_tpu_torch on NVIDIA GPUs.

One run is one process:

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It reads the cell from BENCHMARK.json at the root of the checkout and finds
everything that belongs to it by name, so a later change adds a cell by
adding files:

* ``configs/<config>.json``: a model configuration (sizes, optimizers,
  dtype, the peak its MFU divides by). Its ``"model"`` names the program
  builder ``programs/<model>.py`` (the port's public API: ``model``,
  ``linears``, ``scores``, and where it needs them its own
  ``sparse_batch`` and ``KERNELS``) and the plain reference
  ``reference/<model>.py`` (``linear_shapes``, ``forward``, ``loss``,
  ``flops_per_example``, ``tiny_sizes`` for the CPU tests, and
  ``linear_biases`` where a layer has no bias). ``drivers/train.py``
  lists every key.
* ``traffic/<mix>.json``: a traffic mix, parameters only (its ids a
  feature one int, or a list of one length a feature). Its ``"driver"``
  names the general generator and loop ``drivers/<driver>.py``.
* ``metrics/<metric>.py``: one reader a metric, ``read(ctx) -> float |
  None``; None leaves the metric out of the result line.
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct`` in that cell.

The yardstick lives here and never in the program: the input generator
(``inputs.py``), the operation and byte counts (``work.py``), the table of
peaks (``peaks.py``), the trace reduction (``trace.py``), the plain
references and the comparison (``check.py``). Nothing here imports JAX or
the JAX package; ``guard.py`` checks that at the end of every run.
"""
