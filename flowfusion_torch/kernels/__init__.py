"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each with
its plain PyTorch version beside it.  CUDA tensors launch the kernel, CPU
tensors run the plain version."""
