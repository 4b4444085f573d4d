from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import (ssd_chunked, ssd_decode_step,
                                        ssd_state_passing)

__all__ = ["ssd", "ssd_chunked", "ssd_decode_step", "ssd_state_passing"]
