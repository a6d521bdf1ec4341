"""The port's benchmark: one cell of BENCHMARK.json a run
(``python portbench/run.py --workload CELL --seed N --seconds S --trace
0|1``)."""
