"""Weight-only quantization of the port's parameter modules."""
from repro_torch.quant.quantize import (  # noqa: F401
    QTensor,
    QuantizedParams,
    dequantize,
    dequantize_pytree,
    quant_error,
    quantize,
    quantize_pytree,
    quantized_bytes,
)
