"""Kernels of the analytics data plane: the partition kernels K1–K3 in CUDA
for Hopper (``csrc/partition.cu``), their wrappers (``partition``), their
plain PyTorch versions (``ref``) and the one dispatch point (``ops``)."""
