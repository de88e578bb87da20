"""The benchmark of the PyTorch / CUDA port (`dreamscene_tpu_torch`) on one
NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the repository root names the cells, metrics and
configurations; everything that belongs to one of them sits in a file of its
own here, found by name:

  configs/<config>.json    a configuration as it is run, with its source
  traffic/<traffic>.json   a traffic mix: the driver that runs it and its
                           parameters (drivers/<driver>.py)
  metrics/<metric>.py      one reader per metric, `read(ctx)`
  limits/<cell>.json       the limits of each number the correctness check
                           compares, and the readings they were set from
  counts/                  operations and bytes of the kernels and models
  reference/               the plain PyTorch reference the outputs are
                           compared with; it imports nothing of the program

Nothing here imports `jax` or the JAX package `dreamscene_tpu`; the
reference imports nothing of `dreamscene_tpu_torch` either.
"""
