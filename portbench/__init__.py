"""portbench: the benchmark of sctl_tpu_torch, the PyTorch and CUDA
port, on NVIDIA cards.  `python3 -m portbench.run --help`."""
