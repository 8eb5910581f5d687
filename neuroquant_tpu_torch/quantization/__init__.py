from neuroquant_tpu_torch.quantization.spec import QuantSpec, make_spec  # noqa: F401
from neuroquant_tpu_torch.quantization.qmodel import (  # noqa: F401
    adaround_upgrade, average_bits, collect_int_codes, get_perturbation,
    init_quant_state, quantize_params, round_loss,
)
from neuroquant_tpu_torch.quantization.calibrate import (  # noqa: F401
    LinearTempDecay, model_reconstruction,
)
from neuroquant_tpu_torch.quantization.sensitivity import (  # noqa: F401
    MAX_BATCHES, hessian_vector_product, sensitivity_criterion,
)
from neuroquant_tpu_torch.quantization.calib_unit import (  # noqa: F401
    block_reconstruction, layer_reconstruction,
)
