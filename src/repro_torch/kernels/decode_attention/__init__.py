from repro_torch.kernels.decode_attention.ops import (
    combine_partials, decode_attention, decode_attention_partials,
    paged_decode_attention, paged_decode_attention_dequant,
    paged_verify_attention, paged_verify_attention_dequant)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partials_plain, decode_attention_plain,
    paged_decode_attention_dequant_plain, paged_decode_attention_plain,
    paged_verify_attention_dequant_plain, paged_verify_attention_plain)

__all__ = ["combine_partials", "decode_attention",
           "decode_attention_partials", "paged_decode_attention",
           "paged_decode_attention_dequant", "paged_verify_attention",
           "paged_verify_attention_dequant",
           "decode_attention_partials_plain", "decode_attention_plain",
           "paged_decode_attention_plain",
           "paged_decode_attention_dequant_plain",
           "paged_verify_attention_plain",
           "paged_verify_attention_dequant_plain"]
