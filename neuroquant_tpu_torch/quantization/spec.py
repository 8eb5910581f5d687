"""Static quantization configuration: which layers, how many bits, which
domain (the counterpart of ``neuroquant_tpu/quantization/spec.py``). The
optimizable part (deltas, zero points, AdaRound alphas) is a separate
QuantState dict (qmodel.py)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from neuroquant_tpu_torch.models import quant_layer_paths
from neuroquant_tpu_torch.utils.convert import layer_prefix


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    layer_names: Tuple[str, ...]              # keys into QuantState
    layer_paths: Tuple[Tuple[str, ...], ...]  # flax paths of the layers
    layer_keys: Tuple[str, ...]               # their state-dict prefixes
    n_bits: Tuple[int, ...]                   # per-layer bit width
    channel_wise: bool = True
    scale_method: str = "max"
    hadamard: bool = False
    sym: bool = False
    # weight fake-quant implementation, under the JAX package's names:
    # 'jnp', the plain tensor chain; 'pallas', the fused CUDA kernel of
    # ops/fused_fakequant.py
    fq_impl: str = "jnp"

    def __post_init__(self):
        if not (len(self.layer_names) == len(self.layer_paths)
                == len(self.layer_keys) == len(self.n_bits)):
            raise ValueError("layer_names, layer_paths, layer_keys and "
                             "n_bits differ in length")
        for b in self.n_bits:
            if not 2 <= b <= 8:
                raise ValueError(f"bitwidth not supported: {b}")
        if self.fq_impl not in ("jnp", "pallas"):
            raise ValueError(f"fq_impl={self.fq_impl!r} (use 'jnp' or "
                             "'pallas')")

    def with_bits(self, bits) -> "QuantSpec":
        bits = tuple(int(b) for b in bits)
        if len(bits) != len(self.layer_names):
            raise ValueError(f"need {len(self.layer_names)} bit entries, "
                             f"got {len(bits)}")
        return dataclasses.replace(self, n_bits=bits)

    @property
    def num_layers(self) -> int:
        return len(self.layer_names)


def make_spec(arch: str, cfg: dict, n_bits: int = 8, channel_wise: bool = True,
              scale_method: str = "max", hadamard: bool = False,
              sym: bool = False, fq_impl: str = "jnp") -> QuantSpec:
    """Spec over the arch's quantizable conv layers in traversal order."""
    paths = tuple(tuple(p) for p in quant_layer_paths(arch, cfg))
    return QuantSpec(layer_names=tuple("/".join(p) for p in paths),
                     layer_paths=paths,
                     layer_keys=tuple(layer_prefix(p, arch) for p in paths),
                     n_bits=(n_bits,) * len(paths),
                     channel_wise=channel_wise, scale_method=scale_method,
                     hadamard=hadamard, sym=sym, fq_impl=fq_impl)
