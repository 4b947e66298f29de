"""PyTorch and CUDA port of the HOPAAS service.

``repro_torch.core`` mirrors ``repro.core``: the same wire protocol,
storage engine and samplers, with the two acquisition kernels (TPE's
Parzen mixture and GP's Matérn-5/2 covariance) written in CUDA C++ for
Hopper.  The package imports no JAX.  Its entry points run on the CUDA
device unless the caller asks for ``device="cpu"``.
"""
