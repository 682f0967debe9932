"""The benchmark of the PyTorch/CUDA port (`ubteacher_tpu_torch`):
`python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>`."""
