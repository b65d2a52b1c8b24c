"""The benchmark of the PyTorch port (dmsa_lidar_slam_tpu_torch) on one
NVIDIA H100: `python3 bench_port/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout."""
