"""The benchmark of ``ray_tpu_torch`` on the H100: one run is one cell
(a model configuration under a traffic mix), ``python3 -m benchmark.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
