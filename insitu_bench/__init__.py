"""The benchmark of the PyTorch/CUDA port of Wilkins (``repro_torch``): one
cell per run, ``python3 insitu_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  See ``run.py``."""
