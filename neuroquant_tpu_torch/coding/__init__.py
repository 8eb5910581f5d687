from neuroquant_tpu_torch.coding.codec import (  # noqa: F401
    encode_symbols, decode_symbols, compress_artifact, decompress_artifact,
)
