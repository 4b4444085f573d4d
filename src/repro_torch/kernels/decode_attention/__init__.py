from repro_torch.kernels.decode_attention.ops import (
    paged_decode_attention, paged_decode_attention_dequant,
    paged_verify_attention, paged_verify_attention_dequant)
from repro_torch.kernels.decode_attention.ref import (
    paged_decode_attention_dequant_plain, paged_decode_attention_plain,
    paged_verify_attention_dequant_plain, paged_verify_attention_plain)

__all__ = ["paged_decode_attention", "paged_decode_attention_dequant",
           "paged_verify_attention", "paged_verify_attention_dequant",
           "paged_decode_attention_plain",
           "paged_decode_attention_dequant_plain",
           "paged_verify_attention_plain",
           "paged_verify_attention_dequant_plain"]
