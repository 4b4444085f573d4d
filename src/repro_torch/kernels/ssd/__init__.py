from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_decode_step

__all__ = ["ssd", "ssd_chunked", "ssd_decode_step"]
