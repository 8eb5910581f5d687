from neuroquant_tpu_torch.quantization.spec import QuantSpec, make_spec  # noqa: F401
from neuroquant_tpu_torch.quantization.qmodel import (  # noqa: F401
    init_quant_state, quantize_params,
)
