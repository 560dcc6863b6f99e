"""The benchmark of ceph_tpu_torch, the port, on NVIDIA H100s.

`python3 -m ecbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json. See harness.py for how
a cell's files are found and run, ops/ for what an op hands the port,
reference/ for the plain reference its outputs are checked against,
peaks.py for the bounds of the rooflines and metrics/ for the readers.
"""
