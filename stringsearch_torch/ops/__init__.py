"""Device kernels of the port: hand-written CUDA for Hopper, each beside its
plain PyTorch version (ref: stringsearch_tpu/ops)."""

from stringsearch_torch.ops.bitonic import device_sort, plain_sort

__all__ = ["device_sort", "plain_sort"]
