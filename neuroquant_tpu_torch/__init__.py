"""NeuroQuant on PyTorch and CUDA: a port of NeuroQuant-TPU, slice by slice.

A port of the JAX package ``neuroquant_tpu`` to PyTorch, with the decoder
tail's TPU kernels rewritten as hand-written CUDA kernels for NVIDIA Hopper
(``csrc/``). Module layout and names follow the JAX package, so each module
here has a counterpart there; tensors keep the JAX layouts (NHWC frames and
activations, channels-first flat ``(B, C8, Mp)`` tail activations, HWIO
quantization state).

It covers HNeRV's network-wise calibration (``methods.calibrate_network``,
forward and backward through the fused tail's kernels) and quantized
decoding (``methods.eval_quantized``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper runs its plain PyTorch version.

The package never imports JAX or ``neuroquant_tpu``.
"""

__version__ = "0.1.0"
