from repro_torch.kernels.quantize.ops import dequantize, quantize_ef
from repro_torch.kernels.quantize.ref import (QDTYPES, QMAX, SCALE_EPS,
                                              dequantize_plain,
                                              quantize_axis,
                                              quantize_ef_plain,
                                              reference_dequantize,
                                              reference_quantize_ef,
                                              target_dtype)

__all__ = ["QDTYPES", "QMAX", "SCALE_EPS", "dequantize", "dequantize_plain",
           "quantize_axis", "quantize_ef", "quantize_ef_plain",
           "reference_dequantize", "reference_quantize_ef", "target_dtype"]
