from repro_torch.kernels.decode_attention.ops import (
    decode_attention, paged_decode_attention, paged_decode_attention_dequant,
    paged_verify_attention, paged_verify_attention_dequant)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_plain, paged_decode_attention_dequant_plain,
    paged_decode_attention_plain, paged_verify_attention_dequant_plain,
    paged_verify_attention_plain)

__all__ = ["decode_attention", "paged_decode_attention",
           "paged_decode_attention_dequant", "paged_verify_attention",
           "paged_verify_attention_dequant", "decode_attention_plain",
           "paged_decode_attention_plain",
           "paged_decode_attention_dequant_plain",
           "paged_verify_attention_plain",
           "paged_verify_attention_dequant_plain"]
