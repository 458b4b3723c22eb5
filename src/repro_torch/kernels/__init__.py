"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``), each beside
its plain PyTorch version, plus the layout glue they share."""
