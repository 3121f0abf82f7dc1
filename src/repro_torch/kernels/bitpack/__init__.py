"""The bitmap codec's bit-pack (``repro.kernels.bitpack``): a CUDA kernel
with its plain version, and the flat-mask glue around it."""
from repro_torch.kernels.bitpack.ops import bitmap_payload, bitpack_bytes

__all__ = ["bitmap_payload", "bitpack_bytes"]
