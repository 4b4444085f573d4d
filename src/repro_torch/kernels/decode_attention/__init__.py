from repro_torch.kernels.decode_attention.ops import (paged_decode_attention,
                                                       paged_verify_attention)
from repro_torch.kernels.decode_attention.ref import (
    paged_decode_attention_plain, paged_verify_attention_plain)

__all__ = ["paged_decode_attention", "paged_verify_attention",
           "paged_decode_attention_plain", "paged_verify_attention_plain"]
