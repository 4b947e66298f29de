"""The workload's kernels, written by hand for Hopper (``<op>/csrc/*.cu``,
built with nvcc for ``sm_90a`` by ``repro_torch.core.kernels.build_all``
and loaded with ctypes).  Each op launches its kernel for CUDA tensors
and takes its plain PyTorch version (``<op>/ref.py``) only for CPU
tensors."""
