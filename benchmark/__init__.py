"""The benchmark of semicp_torch, the PyTorch and CUDA port.

Run one cell once from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, metric, check
or kernel stage lives in a file of its own under `configs/`, `traffic/`,
`metrics/`, `checks/` and `stages/`, found by the name `BENCHMARK.json`
or the configuration gives it.
The yardstick (the scene generator, the plain reference, the roofline
arithmetic and the comparison that decides `correct`) imports neither JAX,
the JAX package, nor anything of the program.
"""
